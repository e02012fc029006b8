// Decode attention over the narrator's two caches, for Hopper (sm_90a): K8.
//
// Replaces no TPU kernel: the JAX package has no generative path. It was
// added for LaViLa's narrator (models/gpt2.py), whose decode steps ran
// cuDNN's flash SDPA with one query row a head, a poor fit for a kernel
// that tiles 64-128 query rows (44% of the byte bound, PERF.md section 5).
//
// What it computes: scaled dot-product attention of bf16 query rows over
// bf16 keys and values of head width 64, the scores, the softmax and the
// sums in f32, no mask, a bf16 output; ops/decode_attention.py states the
// two modes and holds their plain versions (self_attention_ref,
// cross_attention_ref):
//   - self (decode_sdpa_self_kernel): one query row a (sequence, head) over
//     the first `keys` positions of its (S, 64) block of the self cache;
//   - cross (decode_sdpa_cross_kernel): a clip's R query rows a head over
//     the clip's M latent keys and values, read once for all R rows.
// The output is written as (rows, heads * 64), the layout c_proj takes. No
// atomics and a fixed order of every sum, so a CUDA graph's replay gives
// the eager call's bits; the kernels allocate nothing and launch on the
// caller's stream.
//
// Bound: bytes. One query row a head is far below the card's ~295
// operations a byte: the self mode does 4 operations for every 4 bytes of
// keys and values it reads, the cross mode 40 (R = 10). At the narrator's
// batch (640 sequences x 25 heads, 1-77 positions; 64 clips x 256 latents)
// a traced batch reads 788.9 GB, 0.2355 s at 3.35 TB/s
// (hhbench/counts/narrator.py::decode_attn_work).
//
// Design:
//   - self: 8 lanes an item, each holding 8 of the 64 query values (16
//     bytes) in f32, prescaled by scale * log2(e); 4 items a warp, 16 a
//     block of 128 threads, so the narrator's 16000 items are 1000 blocks,
//     one wave at 8 blocks an SM (the launch bounds keep a thread at 64
//     registers). Each lane streams its 16-byte slices of kKeysAStep key
//     and value rows at once (8 loads in flight a lane, each warp load
//     four whole 128-byte rows), reduces each dot product by three shuffles
//     within its 8 lanes (every lane gets the same bits), and folds the
//     keys into a running max, sum and 8 f32 output values (exp2, the
//     online softmax); the last step divides and stores 16 bytes a lane.
//   - cross: one block of 4 warps a (clip, head, tile of 16 query rows):
//     cp.async stages the clip's keys and values (M x 64 each) and the rows
//     (zeros past R) in shared memory, rows padded to 72 values against
//     bank conflicts; warp w takes the key tiles of 16 w, w + 4, ...: S = Q
//     K^T on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums), the
//     online softmax in f32, and O += P V with P carried as a bf16 pair
//     (P = hi + lo, two products: 16 significant bits, where a flash kernel
//     keeps 8). The 4 warps' (max, sum, O) meet in shared memory (the key
//     buffer, no longer read) and 128 threads merge them in warp order and
//     store 16 bytes each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using attn::cp_async16;
using attn::fast_exp2;
using attn::ldsm_x4;
using attn::ldsm_x4_trans;
using attn::mma_bf16;
using attn::pack_bf16;
using attn::split_bf16;

constexpr int kDh = 64;
constexpr float kLog2e = 1.4426950408889634f;

// self mode
constexpr int kLanes = 8;                      // lanes an item, 8 values (16 bytes) each
constexpr int kSelfThreads = 128;
constexpr int kSelfItems = kSelfThreads / kLanes;  // items a block
constexpr int kSelfBlocksPerSm = 8;
constexpr int kKeysAStep = 4;                  // key (and value) rows a lane has in flight

// cross mode
constexpr int kCrossWarps = 4;                 // 4 or more
constexpr int kCrossThreads = kCrossWarps * 32;
constexpr int kRowTile = 16;                   // query rows a block: the mma's M
constexpr int kRs = kDh + 8;                   // a staged row's stride in bf16 values
constexpr int kMaxCrossKeys = 512;             // ops/decode_attention.py's MAX_CROSS_KEYS
constexpr int kMergeStride = kDh + 4;          // a merged row's stride in floats
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint4 ld_stream(const bf16* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// 8 bf16 values to f32 (exact: a shift).
__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8], float s) {
  return make_uint4(pack_bf16(f[0] * s, f[1] * s), pack_bf16(f[2] * s, f[3] * s),
                    pack_bf16(f[4] * s, f[5] * s), pack_bf16(f[6] * s, f[7] * s));
}

// Self mode. q: (items) rows of 64 at q + n * q_sn + h * q_sh; k, v: each
// item's `keys` rows of 64 at k + n * kv_sn + h * kv_sh + s * 64; out:
// (n, heads * 64) contiguous. sl2 = scale * log2(e).
__global__ void __launch_bounds__(kSelfThreads, kSelfBlocksPerSm)
    decode_sdpa_self_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, long long items,
                            int heads, int keys, long long q_sn, long long q_sh, long long kv_sn,
                            long long kv_sh, float sl2) {
  const long long item = static_cast<long long>(blockIdx.x) * kSelfItems + (threadIdx.x / kLanes);
  if (item >= items) return;  // a whole group of 8 lanes leaves together
  const int lane = threadIdx.x & 31;
  const int c = lane & (kLanes - 1);
  const unsigned group = 0xffu << (lane & ~(kLanes - 1));
  const long long n = item / heads;
  const int h = static_cast<int>(item - n * heads);

  float qf[8];
  unpack8(*reinterpret_cast<const uint4*>(q + n * q_sn + h * q_sh + c * 8), qf);
#pragma unroll
  for (int j = 0; j < 8; ++j) qf[j] *= sl2;
  const long long base = n * kv_sn + h * kv_sh + c * 8;
  const bf16* kp = k + base;
  const bf16* vp = v + base;

  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int s0 = 0; s0 < keys; s0 += kKeysAStep) {
    uint4 kr[kKeysAStep], vr[kKeysAStep];
#pragma unroll
    for (int u = 0; u < kKeysAStep; ++u) {
      if (s0 + u < keys) {
        kr[u] = ld_stream(kp + static_cast<long long>(s0 + u) * kDh);
        vr[u] = ld_stream(vp + static_cast<long long>(s0 + u) * kDh);
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float sc[kKeysAStep];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kKeysAStep; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
      float d = qf[0] * kf[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) d = fmaf(qf[j], kf[j], d);
      d += __shfl_xor_sync(group, d, 1);
      d += __shfl_xor_sync(group, d, 2);
      d += __shfl_xor_sync(group, d, 4);
      sc[u] = s0 + u < keys ? d : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = fast_exp2(m - mx);  // 0 at the first step (m = -inf)
    m = mx;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < kKeysAStep; ++u) {
      const float p = fast_exp2(sc[u] - mx);
      float vf[8];
      unpack8(vr[u], vf);
      l += p;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, vf[j], acc[j]);
    }
  }
  *reinterpret_cast<uint4*>(out + n * heads * kDh + h * kDh + c * 8) = pack8(acc, 1.f / l);
}

__host__ __device__ constexpr int cross_tiles(int m) { return (m + 15) / 16; }

size_t cross_smem_bytes(int m) {
  const size_t kv = static_cast<size_t>(2 * cross_tiles(m) * 16 * kRs) * sizeof(bf16);
  const size_t merge = static_cast<size_t>(kCrossWarps * kRowTile * (kMergeStride + 2)) * sizeof(float);
  return (kv > merge ? kv : merge) + static_cast<size_t>(kRowTile * kRs) * sizeof(bf16);
}

// Cross mode. Block (clip * heads + head, tile of 16 rows). q: row (clip *
// r_rows + row) of a head at q + row * q_sn + h * q_sh; k, v: the clip's
// (m_keys, 64) at k + b * kv_sb + h * kv_sh; out: (clips * r_rows, heads *
// 64) contiguous.
__global__ void __launch_bounds__(kCrossThreads)
    decode_sdpa_cross_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ out, int heads,
                             int r_rows, int m_keys, long long q_sn, long long q_sh,
                             long long kv_sb, long long kv_sh, float sl2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = cross_tiles(m_keys);
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + tiles * 16 * kRs;
  const size_t kv_bytes = static_cast<size_t>(2 * tiles * 16 * kRs) * sizeof(bf16);
  const size_t merge_bytes = static_cast<size_t>(kCrossWarps * kRowTile * (kMergeStride + 2)) * sizeof(float);
  bf16* sq = reinterpret_cast<bf16*>(smem + (kv_bytes > merge_bytes ? kv_bytes : merge_bytes));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / heads, h = blockIdx.x - b * heads;
  const int r0 = blockIdx.y * kRowTile;
  const int rows = min(kRowTile, r_rows - r0);
  const long long row0 = static_cast<long long>(b) * r_rows + r0;

  // stage the rows (zeros past the clip's last), one chunk a thread; then
  // each warp its own key tiles, then their values: a warp reads only what
  // it copied, so after the rows it waits for nothing but its own copies
  if (tid < kRowTile * 8) {  // 16 rows x 8 chunks
    const int row = tid >> 3, ch = tid & 7;
    const bool ok = row < rows;
    cp_async16(sq + row * kRs + ch * 8, ok ? q + (row0 + row) * q_sn + h * q_sh + ch * 8 : q, ok);
  }
  attn::cp_async_commit();
  const bf16* kb = k + b * kv_sb + h * kv_sh;
  const bf16* vb = v + b * kv_sb + h * kv_sh;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const bf16* src = pass ? vb : kb;
    bf16* dst = pass ? sv : sk;
    for (int t = warp; t < tiles; t += kCrossWarps) {
#pragma unroll
      for (int i = lane; i < 16 * 8; i += 32) {
        const int row = t * 16 + (i >> 3), ch = i & 7;
        const bool ok = row < m_keys;
        cp_async16(dst + row * kRs + ch * 8, ok ? src + row * kDh + ch * 8 : src, ok);
      }
    }
    attn::cp_async_commit();
  }
  attn::cp_async_wait_pending(2);
  __syncthreads();  // every thread's rows have landed

  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    ldsm_x4(qa[kk], sq + (((lane >> 3) & 1) * 8 + (lane & 7)) * kRs + kk * 16 + ((lane >> 4) & 1) * 8);
  attn::cp_async_wait_pending(1);
  __syncwarp();  // this warp's keys

  // S = Q K^T of every tile of this warp first (the values may still land)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g4, g4 + 8
  float o[kDh / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  bool waited = false;
  for (int t = warp; t < tiles; t += kCrossWarps) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, sk + (t * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * kRs + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qa[kk], kf[0], kf[1]);
      mma_bf16(s[1], qa[kk], kf[2], kf[3]);
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * 16 + nt * 8 + tq * 2 + (e & 1);
        const float x = key < m_keys ? s[nt][e] : -INFINITY;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(attn::FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(attn::FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(attn::FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(attn::FULL, mx1, 2));
    const float cr0 = fast_exp2(sl2 * (m0 - mx0)), cr1 = fast_exp2(sl2 * (m1 - mx1));
    m0 = mx0;
    m1 = mx1;
    const float ms0 = sl2 * m0, ms1 = sl2 * m1;
    l0 *= cr0;
    l1 *= cr1;
#pragma unroll
    for (int nt = 0; nt < kDh / 8; ++nt) {
      o[nt][0] *= cr0;
      o[nt][1] *= cr0;
      o[nt][2] *= cr1;
      o[nt][3] *= cr1;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = fast_exp2(fmaf(s[nt][0], sl2, -ms0));
      s[nt][1] = fast_exp2(fmaf(s[nt][1], sl2, -ms0));
      s[nt][2] = fast_exp2(fmaf(s[nt][2], sl2, -ms1));
      s[nt][3] = fast_exp2(fmaf(s[nt][3], sl2, -ms1));
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    uint32_t pa[4], pr[4];
    split_bf16(s[0][0], s[0][1], pa[0], pr[0]);
    split_bf16(s[0][2], s[0][3], pa[1], pr[1]);
    split_bf16(s[1][0], s[1][1], pa[2], pr[2]);
    split_bf16(s[1][2], s[1][3], pa[3], pr[3]);
    if (!waited) {  // warp-uniform: this warp's values, at its first tile
      attn::cp_async_wait_pending(0);
      __syncwarp();
      waited = true;
    }
#pragma unroll
    for (int dp = 0; dp < kDh / 16; ++dp) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, sv + (t * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRs + dp * 16 + ((lane >> 4) & 1) * 8);
      mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      mma_bf16(o[2 * dp], pr, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pr, vf[2], vf[3]);
    }
  }
  l0 += __shfl_xor_sync(attn::FULL, l0, 1);
  l0 += __shfl_xor_sync(attn::FULL, l0, 2);
  l1 += __shfl_xor_sync(attn::FULL, l1, 1);
  l1 += __shfl_xor_sync(attn::FULL, l1, 2);

  // the warps' partials meet in the key buffer
  __syncthreads();  // no warp reads its keys or values any more
  float* mo = reinterpret_cast<float*>(smem);                              // [warp][row][kMergeStride]
  float* mml = mo + kCrossWarps * kRowTile * kMergeStride;                 // [warp][row][2]
  float* mine = mo + warp * kRowTile * kMergeStride;
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt) {
    const int cidx = nt * 8 + tq * 2;
    mine[g4 * kMergeStride + cidx] = o[nt][0];
    mine[g4 * kMergeStride + cidx + 1] = o[nt][1];
    mine[(g4 + 8) * kMergeStride + cidx] = o[nt][2];
    mine[(g4 + 8) * kMergeStride + cidx + 1] = o[nt][3];
  }
  if (tq == 0) {
    float* ml = mml + warp * kRowTile * 2;
    ml[g4 * 2] = m0;
    ml[g4 * 2 + 1] = l0;
    ml[(g4 + 8) * 2] = m1;
    ml[(g4 + 8) * 2 + 1] = l1;
  }
  __syncthreads();
  const int row = tid >> 3, ch = tid & 7;  // the first 128 threads: 16 rows x 8 chunks
  if (row >= rows) return;
  float mt = -INFINITY;
#pragma unroll
  for (int w = 0; w < kCrossWarps; ++w) mt = fmaxf(mt, mml[(w * kRowTile + row) * 2]);
  float lt = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
  for (int w = 0; w < kCrossWarps; ++w) {
    const float f = fast_exp2(sl2 * (mml[(w * kRowTile + row) * 2] - mt));  // 0 for a warp without keys
    lt += f * mml[(w * kRowTile + row) * 2 + 1];
    const float* src = mo + (w * kRowTile + row) * kMergeStride + ch * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(f, src[j], acc[j]);
  }
  *reinterpret_cast<uint4*>(out + (row0 + row) * heads * kDh + h * kDh + ch * 8) = pack8(acc, 1.f / lt);
}

cudaError_t grant(int bytes) {
  static int granted[kMaxDevices];  // dynamic shared memory already allowed, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_sdpa_cross_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)  // the most shared memory an SM has, for 3 blocks an SM at M = 256
    err = cudaFuncSetAttribute(decode_sdpa_cross_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Self mode: `items` = sequences x heads query rows, each over its first
// `keys` cached positions. Strides in elements, each a multiple of 8; the
// caller allocates `out` (sequences, heads * 64). Returns 0 or a
// cudaError_t.
extern "C" int hh_decode_sdpa_self(const void* q, const void* k, const void* v, void* out,
                                   long long items, int heads, int keys, long long q_sn,
                                   long long q_sh, long long kv_sn, long long kv_sh, float scale,
                                   void* stream) {
  if (items < 0 || heads < 1 || keys < 1 || items % heads ||
      (q_sn | q_sh | kv_sn | kv_sh) & 7 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return 0;
  const long long blocks = (items + kSelfItems - 1) / kSelfItems;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  decode_sdpa_self_kernel<<<static_cast<unsigned>(blocks), kSelfThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), items, heads, keys, q_sn, q_sh, kv_sn, kv_sh, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Cross mode: `clips` x `r_rows` query rows a head over the clip's `m_keys`
// keys and values (1 .. kMaxCrossKeys). Strides as above. Returns 0 or a
// cudaError_t.
extern "C" int hh_decode_sdpa_cross(const void* q, const void* k, const void* v, void* out,
                                    int clips, int heads, int r_rows, int m_keys, long long q_sn,
                                    long long q_sh, long long kv_sb, long long kv_sh, float scale,
                                    void* stream) {
  if (clips < 0 || heads < 1 || r_rows < 1 || m_keys < 1 || m_keys > kMaxCrossKeys ||
      static_cast<long long>(clips) * heads > 0x7fffffffLL || (q_sn | q_sh | kv_sb | kv_sh) & 7 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (clips == 0) return 0;
  const size_t bytes = cross_smem_bytes(m_keys);
  cudaError_t err = grant(static_cast<int>(cross_smem_bytes(kMaxCrossKeys)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(clips * heads), static_cast<unsigned>((r_rows + kRowTile - 1) / kRowTile));
  decode_sdpa_cross_kernel<<<grid, kCrossThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), heads, r_rows, m_keys, q_sn, q_sh, kv_sb, kv_sh, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Each mode's cut on this device: plan = {threads a block, blocks an SM
// (occupancy), SMs, dynamic shared memory bytes a block (cross at
// m_keys)}. mode 0 self, 1 cross. Returns 0 or a cudaError_t.
extern "C" int hh_decode_sdpa_plan(int mode, int m_keys, long long* plan) {
  if (mode != 0 && (mode != 1 || m_keys < 1 || m_keys > kMaxCrossKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  size_t bytes = 0;
  if (mode == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_sdpa_self_kernel, kSelfThreads, 0);
  } else {
    bytes = cross_smem_bytes(m_keys);
    if ((err = grant(static_cast<int>(cross_smem_bytes(kMaxCrossKeys)))) == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_sdpa_cross_kernel, kCrossThreads,
                                                          bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = mode == 0 ? kSelfThreads : kCrossThreads;
  plan[1] = per_sm;
  plan[2] = sms;
  plan[3] = static_cast<long long>(bytes);
  return 0;
}
