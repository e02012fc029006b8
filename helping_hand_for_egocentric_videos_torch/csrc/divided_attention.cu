// Divided space-time attention on packed qkv, for Hopper (sm_90a).
//
// Replaces: helping_hand_for_egocentric_videos_tpu/ops/divided_attention.py,
// `_rows_kernel` as `divided_patch_attention` calls it in mode `space`
// (K1) and mode `time` (K2).
//
// What it computes. qkv is (B, T, N, 3D), the packed [q|k|v] rows exactly as
// the qkv matmul emits them (q not scaled); D = H * DH. A *group* is the set
// of rows a patch query may see besides the CLS token:
//   space: one frame, the N patches of (b, t);
//   time:  one tube,  patch n of (b) in all T frames.
// For every patch query of a group and every head, with f32 logits scaled by
// DH^-0.5 (the scale is applied to the f32 dot, as in the TPU kernel):
//   out = softmax([q.ck | q.k_j for j in group]) @ [cv | v_j]
// and, for the CLS query cq, the streaming-softmax partials over the group's
// patch keys only (the CLS self logit is excluded; merge_cls_partials adds it
// once): m = max_j l_j, s = sum_j exp(l_j - m), co = sum_j exp(l_j - m) v_j,
// with l_j = DH^-0.5 cq.k_j. Partials are (B, G, H, 1|1|DH) f32 with
// G = T (space) or G = N (time).
//
// Bound. Every input byte is needed once: at the serving shape (B=8, T=16,
// N=256, D=1024, bf16) one launch reads 201 MB of qkv and writes 67 MB, about
// 80 us at 3.35 TB/s. Space mode also does 4*B*T*H*N*(N+1)*DH = 34.5 GFLOP,
// about 35 us at the bf16 tensor-core rate, so both modes are bound by bytes
// on an H100. Time mode does (T+1)/(N+1) as much arithmetic.
//
// Design (the simple first version; tensor cores, TMA and a persistent
// schedule are later work). The TPU kernel's block-diagonal packing of tubes
// and its sequential grid do not carry over. Here one thread owns one query
// row: it keeps q and the running output (2*DH floats) in registers and walks
// the group's keys with an online softmax in f32, opened by the CLS key
// (m = l_cls, sum = 1, acc = cv). The block's threads stage tiles of KT keys
// and values of one head in shared memory as f32, so each key is read from
// device memory once per block and then broadcast from shared memory.
//   space: grid (ceil(N/64), H, B*T), 64 threads, one query tile each;
//   time:  grid (1, H, B*N), one warp per (b, n, head) tube (T <= 32 active
//          lanes), so the tube's T rows of this head are read once.
// The first query tile of each group also computes the group's CLS partials:
// its threads split the group's keys for the logits, reduce max and sum over
// the block, then split the DH columns for the weighted sum of values.
// Inputs may be f32 or bf16; every sum is f32; the output has the input type.
//
// K3 (`quant_out=True` of the same TPU kernel, replaces its in-VMEM
// quantization of the output rows). The TPU program holds all heads of its
// rows and takes max|row| over D; here a block holds one head, so no block
// sees a whole row. K3 therefore runs in two launches: this kernel writes
// the normalized per-head output in f32 to a (B, T, N, D) scratch (the
// scale must come from the f32 output, before any bf16 rounding), then
// row_quant.cuh's row kernel, the code K4 and K5 use, takes max|row| over
// all heads and writes the int8 codes and f32 scales. Extra bytes against
// a fused design: the f32 scratch is written and read once (2 x 134 MB at
// the serving shape). The K1/K2 instantiations (TO = T) are unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "row_quant.cuh"

namespace {

constexpr int KT = 64;        // keys staged in shared memory per tile
constexpr int MAX_QT = 64;    // queries (threads) per block
constexpr int JC = 16;        // keys per online-softmax rescale
constexpr int MAX_W = 1024;   // largest group the CLS pass holds

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Max (is_max) or sum of v over the block; blockDim.x is a multiple of 32.
__device__ float block_reduce(float v, bool is_max, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red may still be read by an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = is_max ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

template <typename T, typename TO, int DH>
__global__ void __launch_bounds__(MAX_QT)
divided_attention_kernel(const T* __restrict__ qkv, const T* __restrict__ cls_q,
                         const T* __restrict__ cls_k, const T* __restrict__ cls_v,
                         TO* __restrict__ out, float* __restrict__ part_m,
                         float* __restrict__ part_s, float* __restrict__ part_co,
                         int t_frames, int n_patches, int heads, int time_mode, float scale) {
  __shared__ __align__(16) float ks[KT][DH];
  __shared__ __align__(16) float vs[KT][DH];
  __shared__ __align__(16) float cs[DH];   // CLS key, later the CLS query
  __shared__ __align__(16) float cvs[DH];  // CLS value
  __shared__ float ps[MAX_W];
  __shared__ float red[32];

  const int h = blockIdx.y;
  const long g = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long d = (long)heads * DH, d3 = 3 * d;

  // group g: w member rows at row0 + j * rstride, counted in rows of 3D
  long b, row0, rstride;
  int w;
  if (time_mode) {
    b = g / n_patches;
    row0 = b * t_frames * n_patches + g % n_patches;
    rstride = n_patches;
    w = t_frames;
  } else {
    b = g / t_frames;
    row0 = g * n_patches;
    rstride = 1;
    w = n_patches;
  }
  const long hcol = (long)h * DH;
  const long cls_off = b * d + hcol;

  for (int c = tid; c < DH; c += nthr) {
    cs[c] = to_f32(cls_k[cls_off + c]);
    cvs[c] = to_f32(cls_v[cls_off + c]);
  }
  __syncthreads();

  const int qi = blockIdx.x * nthr + tid;
  const bool active = qi < w;
  float q[DH], acc[DH];
  float m, l;
  {
    // an idle thread computes on row 0 of the group and writes nothing
    const T* src = qkv + (row0 + (long)(active ? qi : 0) * rstride) * d3 + hcol;
    float lc = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      q[c] = to_f32(src[c]);
      lc += q[c] * cs[c];
    }
    m = scale * lc;  // the CLS key's logit opens the running softmax
    l = 1.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) acc[c] = cvs[c];
  }

  for (int k0 = 0; k0 < w; k0 += KT) {
    const int nk = min(KT, w - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < nk * DH; idx += nthr) {
      const int j = idx / DH, c = idx % DH;
      const T* row = qkv + (row0 + (long)(k0 + j) * rstride) * d3 + hcol + c;
      ks[j][c] = to_f32(row[d]);
      vs[j][c] = to_f32(row[2 * d]);
    }
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += JC) {
      float s[JC];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = j0 + jj;
        float logit = -CUDART_INF_F;
        if (j < nk) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < DH; ++c) dot += q[c] * ks[j][c];
          logit = scale * dot;
        }
        s[jj] = logit;
        mx = fmaxf(mx, logit);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int c = 0; c < DH; ++c) acc[c] *= corr;
      m = mx;
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = j0 + jj;
        if (j < nk) {
          const float p = expf(s[jj] - m);
          l += p;
#pragma unroll
          for (int c = 0; c < DH; ++c) acc[c] += p * vs[j][c];
        }
      }
    }
  }

  if (active) {
    TO* dst = out + (row0 + (long)qi * rstride) * d + hcol;
#pragma unroll
    for (int c = 0; c < DH; ++c) dst[c] = from_f32<TO>(acc[c] / l);
  }

  if (blockIdx.x != 0) return;  // block-uniform: tile 0 owns the CLS partials

  __syncthreads();  // every thread is done reading cs
  for (int c = tid; c < DH; c += nthr) cs[c] = to_f32(cls_q[cls_off + c]);
  __syncthreads();
  float mx = -CUDART_INF_F;
  for (int j = tid; j < w; j += nthr) {
    const T* krow = qkv + (row0 + (long)j * rstride) * d3 + d + hcol;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) dot += cs[c] * to_f32(krow[c]);
    ps[j] = scale * dot;
    mx = fmaxf(mx, ps[j]);
  }
  mx = block_reduce(mx, true, red);
  float sum = 0.f;
  for (int j = tid; j < w; j += nthr) {
    const float e = expf(ps[j] - mx);
    ps[j] = e;
    sum += e;
  }
  sum = block_reduce(sum, false, red);  // its barriers also publish ps
  const long pidx = g * heads + h;
  for (int c = tid; c < DH; c += nthr) {
    const T* vcol = qkv + row0 * d3 + 2 * d + hcol + c;
    float co = 0.f;
    for (int j = 0; j < w; ++j) co += ps[j] * to_f32(vcol[(long)j * rstride * d3]);
    part_co[pidx * DH + c] = co;
  }
  if (tid == 0) {
    part_m[pidx] = mx;
    part_s[pidx] = sum;
  }
}

// TO = T: the attention output (K1, K2); TO = float: K3's f32 rows.
template <typename T, typename TO, int DH>
int launch(const void* qkv, const void* cls_q, const void* cls_k, const void* cls_v, void* out,
           void* part_m, void* part_s, void* part_co, int batch, int t_frames, int n_patches,
           int heads, int time_mode, float scale, cudaStream_t stream) {
  const int w = time_mode ? t_frames : n_patches;
  const long groups = (long)batch * (time_mode ? n_patches : t_frames);
  if (w < 1 || w > MAX_W || groups < 1 || groups > 65535 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int nthr = w >= MAX_QT ? MAX_QT : ((w + 31) / 32) * 32;
  const dim3 grid((w + nthr - 1) / nthr, heads, (unsigned)groups);
  divided_attention_kernel<T, TO, DH><<<grid, nthr, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(cls_q), static_cast<const T*>(cls_k),
      static_cast<const T*>(cls_v), static_cast<TO*>(out), static_cast<float*>(part_m),
      static_cast<float*>(part_s), static_cast<float*>(part_co), t_frames, n_patches, heads,
      time_mode, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. head_dim is 32 or 64;
// is_bf16 selects bf16 (1) or f32 (0) for qkv, the CLS rows and out.
extern "C" int hh_divided_attention(const void* qkv, const void* cls_q, const void* cls_k,
                                    const void* cls_v, void* out, void* part_m, void* part_s,
                                    void* part_co, int batch, int t_frames, int n_patches,
                                    int heads, int head_dim, int time_mode, int is_bf16,
                                    float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HH_LAUNCH(T, DH)                                                                  \
  return launch<T, T, DH>(qkv, cls_q, cls_k, cls_v, out, part_m, part_s, part_co, batch,    \
                       t_frames, n_patches, heads, time_mode, scale, st)
  if (is_bf16) {
    if (head_dim == 64) HH_LAUNCH(__nv_bfloat16, 64);
    if (head_dim == 32) HH_LAUNCH(__nv_bfloat16, 32);
  } else {
    if (head_dim == 64) HH_LAUNCH(float, 64);
    if (head_dim == 32) HH_LAUNCH(float, 32);
  }
#undef HH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K3. The same attention with its output quantized per token over all heads:
// rows (B, T, N, D) f32 scratch, then codes (B, T, N, D) int8 and scales
// (B, T, N) f32. Two launches on one stream; returns 0 or the first error.
extern "C" int hh_divided_attention_int8(const void* qkv, const void* cls_q, const void* cls_k,
                                         const void* cls_v, void* rows, void* codes,
                                         void* scales, void* part_m, void* part_s, void* part_co,
                                         int batch, int t_frames, int n_patches, int heads,
                                         int head_dim, int time_mode, int is_bf16, float scale,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
#define HH_LAUNCH(T, DH)                                                                    \
  rc = launch<T, float, DH>(qkv, cls_q, cls_k, cls_v, rows, part_m, part_s, part_co, batch, \
                            t_frames, n_patches, heads, time_mode, scale, st)
  if (is_bf16) {
    if (head_dim == 64) HH_LAUNCH(__nv_bfloat16, 64);
    else if (head_dim == 32) HH_LAUNCH(__nv_bfloat16, 32);
  } else {
    if (head_dim == 64) HH_LAUNCH(float, 64);
    else if (head_dim == 32) HH_LAUNCH(float, 32);
  }
#undef HH_LAUNCH
  if (rc != 0) return rc;
  return rowq::launch_rows<rowq::RowOp::kIdentity>(
      static_cast<const float*>(rows), nullptr, nullptr, static_cast<int8_t*>(codes),
      static_cast<float*>(scales), (long long)batch * t_frames * n_patches, heads * head_dim,
      0.f, st);
}
