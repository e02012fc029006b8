// Time attention on long clips with the head in the grid (K6), for Hopper
// (sm_90a).
//
// Replaces: helping_hand_for_egocentric_videos_tpu/ops/divided_attention.py,
// `_time_attention_headgrid` and its kernel `_rows_kernel_hg`, the time
// kernel the JAX package takes where `needs_head_grid(T, N, H)` holds
// (T = 128 at TimeSformer-L widths, N = 256, H = 16).
//
// What it computes. qkv is (B, T, N, 3D), the packed [q|k|v] rows as the qkv
// matmul emits them (q not scaled), D = H * DH. For every patch query of a
// tube (patch n of clip b in all T frames) and every head, with f32 logits
// scaled by DH^-0.5 as the TPU kernel scales them:
//   out = softmax([q.ck | q.k_t for t < T]) @ [cv | v_t]
// written to (B, T, N, D) at the head's columns; and the CLS query's
// streaming-softmax partials over the tube's keys, its self logit excluded:
// m, s, co as (B, N, H, 1|1|DH) f32, one group a tube (merge_cls_partials
// takes any grouping).
//
// What it does not carry over. The TPU version transposes qkv head-major in
// device memory before the kernel and the output back after it, and computes
// nb tubes at a time as one (T*nb)^2 logits product under a same-patch mask.
// Here the kernel reads the packed qkv at its strides and writes (B, T, N, D)
// directly: no transpose pass, no masked products.
//
// Bound. At B = 2, T = 128, N = 256, D = 1024, bf16: 403 MB of qkv in and 134
// MB out, 161 us at 3.35 TB/s; 4*B*T*N*H*DH*(T+2) = 35 GFLOP of products, 35
// us on bf16 tensor cores (0.5 ms at the 67 TFLOP/s f32 CUDA-core peak). So
// the bf16 products go to the tensor cores, and the kernel is bound by its
// bytes. An item, one (clip, tube, head), is 48 KB of q, k and v and 16 KB
// of output for 4 MFLOP; its products, softmax and CLS partials take about
// as long on an SM as its bytes, so loads and arithmetic have to overlap
// inside the SM or the time is their sum.
//
// bf16 design. Persistent blocks walk the items, numbered in (clip, tube,
// head) order with the head fastest; block k of G takes items k, k + G, k +
// 2G, ... The grid is as many blocks as the card holds at once (2 an SM at
// T = 128), and the blocks keep roughly in step, so the items in flight at
// any time are all heads of some 16 neighbouring tubes, whose 128-byte
// slices make up whole 6 KB token rows.
//   - A ring of STAGES item slots in shared memory: an item's q, k and v rows
//     (T x DH bf16 each, T padded to 16 with zeros) and its CLS query, key and
//     value. Every thread issues its share of the 16-byte cp.async copies of
//     item j + 1 before the block computes item j, so the copy of one item
//     runs under the arithmetic of the one before (and the other block of the
//     SM covers the rest). One __syncthreads an item both publishes the item
//     that landed and frees the slot that was read. The rows are stored with
//     the 16-byte chunks of row r permuted by an XOR with r (TMA's 128-byte
//     swizzle at DH = 64, its 64-byte one at DH = 32), so that ldmatrix's
//     eight 16-byte rows hit 32 distinct banks without padding: two slots and
//     the block's scratch fit 2 blocks an SM at T = 128. (cp.async, not TMA:
//     the copies are 16-byte lines of 128-byte rows, all issued at once, and
//     on an H100 SXM at 700 W the loads alone take 0.14 ms at B = 2, T = 128,
//     less than the arithmetic.)
//   - Each warp takes 16-query tiles of the item. Its q fragments come from
//     the staged q rows with ldmatrix where each is used, the key fragments
//     with ldmatrix and the value fragments with ldmatrix.trans from the
//     row-major values (no transposed copy). QK^T and PV run on mma.sync
//     m16n8k16 (bf16 in, f32 sums) over 64-key steps with an f32 online
//     softmax opened by the CLS key, whose logits come from the same
//     instruction (ck as the one non-zero column of a B fragment); the
//     exponentials are 2^x on the special-function unit with DH^-0.5 log2(e)
//     folded into one multiply-add a logit, and a step whose keys are all
//     below T skips the mask. The probabilities enter PV rounded to bf16, as
//     on the TPU; the sums of the softmax stay f32. The output leaves from
//     the fragments, 16 neighbouring bytes a row from its 4 lanes.
//   - The CLS partials inside the pass, on the tensor cores too: after its
//     query tile, a warp takes the CLS query over the same 16 keys (cls_tile:
//     cq as row 0 of an A fragment, P as two bf16 terms for f32 precision)
//     and folds them into its running (m, s, co) in shared memory (two
//     buffers, by item parity); one warp merges the warps' partials of item
//     j after the next __syncthreads and writes them, while the other warps
//     compute item j + 1. No tail, no second read of device memory.
// What holds it back (PERF.md): the arithmetic. With the copies left out it
// takes 0.25 ms of its 0.29 ms at B = 2, T = 128 on the same card: 16 warps
// an SM (128 registers a thread) do not hide the latency of the chains of
// ldmatrix, mma, shuffles and 2^x in the online softmax of 128 keys.
// f32 design (a test and debug type): one block a (clip, tube, head), one
// thread a query on the CUDA cores (q and the running output in registers),
// keys and values staged in f32.
// T <= 256 and DH in {32, 64}; the wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include "attention_mma.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

constexpr int MAX_T = 256;
constexpr int WARPS = 8;   // bf16: most warps a block, each on 16-query tiles
constexpr int KC = 64;     // bf16: keys an online-softmax step
constexpr int STAGES = 2;  // bf16: item slots in a block's ring
constexpr int JC = 16;     // f32: keys per online-softmax rescale

__host__ __device__ constexpr int pad16(int t) { return (t + 15) & ~15; }

// ---------------------------------------------------------------- bf16

// Element offset of (row r, column c) in a staged [rows][DH] bf16 tile: the
// 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ f(r), f(r) = r % 8 for
// 128-byte rows (DH = 64), (r / 2) % 4 for 64-byte rows (DH = 32).
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  const int f = DH == 64 ? (r & 7) : ((r >> 1) & 3);
  return r * DH + (((c >> 3) ^ f) << 3) + (c & 7);
}

// One item slot: q, k, v rows [tp][DH] and the CLS q, k, v rows [3][DH],
// in bf16 elements, rounded up to 128 bytes.
template <int DH>
__host__ __device__ inline int slot_elems(int tp) {
  return (3 * tp * DH + 3 * DH + 63) & ~63;
}

template <int DH>
size_t bf16_smem_bytes(int tp, int nw) {
  return (size_t)STAGES * slot_elems<DH>(tp) * 2 + 2 * (size_t)nw * (DH + 2) * 4;
}

// (x, y) rounded to a bf16 pair h, and the bf16 pair r of what the rounding
// left out: h + r holds about 16 bits of each.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& h, uint32_t& r) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hv);
  const __nv_bfloat162 rv = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  h = *reinterpret_cast<const uint32_t*>(&hv);
  r = *reinterpret_cast<const uint32_t*>(&rv);
}

// The CLS query over the staged keys kt*16 .. kt*16 + 15 (those below T), on
// the tensor cores: cq is row 0 of an A fragment whose other rows are zero,
// so the logits come out in lanes 0-3 (row 0 of the C fragment) as f32 sums
// of exact bf16 products. Its probabilities enter P V as two bf16 terms, the
// rounded value and what the rounding left out (about 16 bits together), so
// that the partials keep f32 precision. The running (m, s, co) of the warp's
// key tiles live in `mine` ([DH + 2] f32 in shared memory); `first` starts
// them.
template <int DH>
__device__ __forceinline__ void cls_tile(const bf16* ks, const bf16* vs, int kt, int t_frames,
                                         const bf16* cq, float scale, float* mine, bool first) {
  const int lane = threadIdx.x & 31, g4 = lane >> 2, tq = lane & 3;
  float sc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
    const uint32_t ca[4] = {g4 == 0 ? ld_pair(cq + c) : 0u, 0u,
                            g4 == 0 ? ld_pair(cq + c + 8) : 0u, 0u};
    uint32_t kb[4];
    ldsm_x4(kb, ks + swz<DH>(kt * 16 + ((lane >> 4) & 1) * 8 + (lane & 7),
                             kk * 16 + ((lane >> 3) & 1) * 8));
    mma_bf16(sc[0], ca, kb[0], kb[1]);
    mma_bf16(sc[1], ca, kb[2], kb[3]);
  }
  // lanes 0-3: keys kt*16 + nt*8 + 2tq + e in sc[nt][e], e < 2
  float lg[2][2], mt = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = g4 == 0 && kt * 16 + nt * 8 + tq * 2 + e < t_frames;
      lg[nt][e] = ok ? scale * sc[nt][e] : -CUDART_INF_F;
      mt = fmaxf(mt, lg[nt][e]);
    }
  }
  mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
  mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
  const float cm = first ? -CUDART_INF_F : mine[0];
  const float mn = fmaxf(cm, mt);  // lanes 0-3: finite, key kt*16 is below T
  float p[2][2], ps = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[nt][e] = g4 == 0 ? expf(lg[nt][e] - mn) : 0.f;
      ps += p[nt][e];
    }
  }
  ps += __shfl_xor_sync(FULL, ps, 1);
  ps += __shfl_xor_sync(FULL, ps, 2);
  uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
  split_pair(p[0][0], p[0][1], ph[0], pl[0]);
  split_pair(p[1][0], p[1][1], ph[2], pl[2]);
  float co[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) co[nt][0] = co[nt][1] = co[nt][2] = co[nt][3] = 0.f;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t vb[4];
    ldsm_x4_trans(vb, vs + swz<DH>(kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                   dp * 16 + ((lane >> 4) & 1) * 8));
    mma_bf16(co[2 * dp], ph, vb[0], vb[1]);
    mma_bf16(co[2 * dp], pl, vb[0], vb[1]);
    mma_bf16(co[2 * dp + 1], ph, vb[2], vb[3]);
    mma_bf16(co[2 * dp + 1], pl, vb[2], vb[3]);
  }
  if (g4 == 0) {  // row 0: columns nt*8 + 2tq, + 1
    const float corr = first ? 0.f : expf(cm - mn);
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      float* dst = mine + 2 + nt * 8 + tq * 2;
      dst[0] = first ? co[nt][0] : dst[0] * corr + co[nt][0];
      dst[1] = first ? co[nt][1] : dst[1] * corr + co[nt][1];
    }
    __syncwarp(0xfu);  // lanes 0-3 have read m and s
    if (tq == 0) {
      mine[1] = first ? ps : mine[1] * corr + ps;
      mine[0] = mn;
    }
  }
  __syncwarp();
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32, 2)
headgrid_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ cls_q,
                     const bf16* __restrict__ cls_k, const bf16* __restrict__ cls_v,
                     bf16* __restrict__ out, float* __restrict__ part_m,
                     float* __restrict__ part_s, float* __restrict__ part_co, int t_frames,
                     int n_patches, int heads, int items, float scale) {
  constexpr int CH = DH / 8, CPL = DH / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int g4 = lane >> 2, tq = lane & 3;  // mma fragment row group, column pair
  const int tp = pad16(t_frames), tiles = tp / 16;
  const int se = slot_elems<DH>(tp);
  bf16* slots = reinterpret_cast<bf16*>(smem);
  float* cpart = reinterpret_cast<float*>(smem + (size_t)STAGES * se * 2);  // [2][nw][DH + 2]
  const long long d = (long long)heads * DH, d3 = 3 * d;
  const long long rstride = (long long)n_patches * d3;  // frame to frame
  // this block's items: blockIdx.x + j * gridDim.x for j < count, in
  // (clip, tube, head) order with the head fastest
  const int count = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  auto item_of = [&](int j) { return (int)blockIdx.x + j * (int)gridDim.x; };

  // item j's rows -> slot (zeros past T); one cp.async group, empty past the last
  auto issue = [&](int j, int slot) {
    if (j < count) {
      const int item = item_of(j);
      const int bn = item / heads, b = bn / n_patches;
      const int hcol = (item - bn * heads) * DH;
      bf16* st = slots + slot * se;
      const bf16* tube =
          qkv + ((long long)b * t_frames * n_patches + bn % n_patches) * d3 + hcol;
#pragma unroll
      for (int z = 0; z < 3; ++z) {  // q, k, v: 16-byte chunk idx is row idx / CH
        for (int idx = tid; idx < tp * CH; idx += blockDim.x) {
          const int r = idx / CH, c = (idx % CH) * 8;
          const bool ok = r < t_frames;
          cp_async16(st + z * tp * DH + swz<DH>(r, c), tube + (ok ? r : 0) * rstride + z * d + c,
                     ok);
        }
      }
      bf16* cl = st + 3 * tp * DH;  // CLS q, k, v
      const long long coff = (long long)b * d + hcol;
      for (int idx = tid; idx < 3 * CH; idx += blockDim.x) {
        const int z = idx / CH, c = (idx - z * CH) * 8;
        cp_async16(cl + z * DH + c, (z == 0 ? cls_q : z == 1 ? cls_k : cls_v) + coff + c, true);
      }
    }
    cp_async_commit();
  };

  // one warp joins the slices of item (cp: its [nw][DH + 2] buffer)
  auto merge = [&](int item, const float* cp) {
    float mg = -CUDART_INF_F;
    for (int i = 0; i < nw; ++i) mg = fmaxf(mg, cp[i * (DH + 2)]);
    float sg = 0.f, cg[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) cg[c] = 0.f;
    for (int i = 0; i < nw; ++i) {
      const float* p = cp + i * (DH + 2);
      const float wt = expf(p[0] - mg);  // an empty slice: exp(-inf) = 0
      sg += p[1] * wt;
#pragma unroll
      for (int c = 0; c < CPL; ++c) cg[c] += p[2 + lane * CPL + c] * wt;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) part_co[(long long)item * DH + lane * CPL + c] = cg[c];
    if (lane == 0) {
      part_m[item] = mg;
      part_s[item] = sg;
    }
  };

  const float sl2 = scale * 1.4426950408889634f;  // exp(scale * x) = 2^(sl2 * x)

  for (int s = 0; s < STAGES - 1; ++s) issue(s, s);
  for (int j = 0; j < count; ++j) {
    const int slot = j % STAGES, it = item_of(j);
    cp_async_wait_pending(STAGES - 2);  // this thread's copies of item j are in
    __syncthreads();  // everyone's are; item j - 1 is read and its CLS slices are in
    issue(j + STAGES - 1, (slot + STAGES - 1) % STAGES);
    if (j > 0 && warp == nw - 1) merge(item_of(j - 1), cpart + ((j - 1) & 1) * nw * (DH + 2));

    const bf16* qs = slots + slot * se;
    const bf16* ks = qs + tp * DH;
    const bf16* vs = ks + tp * DH;
    const bf16* cq = vs + tp * DH;
    const bf16* ck = cq + DH;
    const bf16* cv = ck + DH;
    const int bn = it / heads, b = bn / n_patches, n = bn % n_patches;
    const int hcol = (it - bn * heads) * DH;

    for (int qt = warp; qt < tiles; qt += nw) {
      // the lane's address of the tile's q fragments; a fragment is loaded
      // where it is used, so that none stays live across P V
      const int qr = qt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), qc = ((lane >> 4) & 1) * 8;
      // the CLS key's logits of the tile's rows on the tensor cores: ck is
      // column 0 of a B fragment whose other columns are zero, so row g's
      // logit lands in lane 4g (c0; row g + 8's in c2) as an f32 sum of
      // exact bf16 products
      float lc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, qs + swz<DH>(qr, kk * 16 + qc));
        const int c = kk * 16 + tq * 2;
        mma_bf16(lc, qa, g4 == 0 ? ld_pair(ck + c) : 0u, g4 == 0 ? ld_pair(ck + c + 8) : 0u);
      }
      // the CLS key opens the running softmax: m = its logit (unscaled, as
      // every m below), weight 1 (held once a row, by column pair 0)
      float m0 = __shfl_sync(FULL, lc[0], lane & ~3), m1 = __shfl_sync(FULL, lc[2], lane & ~3);
      float l0 = tq == 0 ? 1.f : 0.f, l1 = l0;
      float o[DH / 8][4];
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const uint32_t u = ld_pair(cv + nt * 8 + tq * 2);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
        o[nt][0] = o[nt][2] = f.x;
        o[nt][1] = o[nt][3] = f.y;
      }

      for (int k0 = 0; k0 < tp; k0 += KC) {
        // S = Q K^T over keys k0 .. k0 + KC: a q fragment of 16 columns at a
        // time, against 16 keys (two n-tiles) a key load
        float s[KC / 8][4];
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t qa[4];
          ldsm_x4(qa, qs + swz<DH>(qr, kk * 16 + qc));
#pragma unroll
          for (int np = 0; np < KC / 16; ++np) {
            if (k0 + np * 16 < tp) {  // warp-uniform
              uint32_t kb[4];
              ldsm_x4(kb, ks + swz<DH>(k0 + np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7),
                                       kk * 16 + ((lane >> 3) & 1) * 8));
              mma_bf16(s[2 * np], qa, kb[0], kb[1]);
              mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
            }
          }
        }
        if (k0 + KC > t_frames) {  // warp-uniform: keys past T take -inf
#pragma unroll
          for (int nt = 0; nt < KC / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (k0 + nt * 8 + tq * 2 + (e & 1) >= t_frames) s[nt][e] = -CUDART_INF_F;
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt) {
          mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
          mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
        const float cr0 = fast_exp2(sl2 * (m0 - mx0)), cr1 = fast_exp2(sl2 * (m1 - mx1));
        m0 = mx0;
        m1 = mx1;
        const float ms0 = sl2 * m0, ms1 = sl2 * m1;
        l0 *= cr0;
        l1 *= cr1;
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt) {
          o[nt][0] *= cr0;
          o[nt][1] *= cr0;
          o[nt][2] *= cr1;
          o[nt][3] *= cr1;
        }
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt) {
          s[nt][0] = fast_exp2(fmaf(s[nt][0], sl2, -ms0));
          s[nt][1] = fast_exp2(fmaf(s[nt][1], sl2, -ms0));
          s[nt][2] = fast_exp2(fmaf(s[nt][2], sl2, -ms1));
          s[nt][3] = fast_exp2(fmaf(s[nt][3], sl2, -ms1));
          l0 += s[nt][0] + s[nt][1];
          l1 += s[nt][2] + s[nt][3];
        }
        // O += P V, 16 keys a step: two logits tiles make one A fragment
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if (k0 + kk * 16 < tp) {  // warp-uniform
            const uint32_t pa[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int dp = 0; dp < DH / 16; ++dp) {
              uint32_t vb[4];
              ldsm_x4_trans(vb, vs + swz<DH>(k0 + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                             dp * 16 + ((lane >> 4) & 1) * 8));
              mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
              mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
            }
          }
        }
      }

      l0 += __shfl_xor_sync(FULL, l0, 1);
      l0 += __shfl_xor_sync(FULL, l0, 2);
      l1 += __shfl_xor_sync(FULL, l1, 1);
      l1 += __shfl_xor_sync(FULL, l1, 2);
      const int r0 = qt * 16 + g4, r1 = r0 + 8;
      bf16* o0 = out + (((long long)b * t_frames + r0) * n_patches + n) * d + hcol;
      bf16* o1 = out + (((long long)b * t_frames + r1) * n_patches + n) * d + hcol;
      const float il0 = 1.f / l0, il1 = 1.f / l1;  // the bf16 output hides the last bit
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const int c = nt * 8 + tq * 2;
        if (r0 < t_frames)
          *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
              __floats2bfloat162_rn(o[nt][0] * il0, o[nt][1] * il0);
        if (r1 < t_frames)
          *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
              __floats2bfloat162_rn(o[nt][2] * il1, o[nt][3] * il1);
      }

      // the CLS query over the keys of this tile -> the warp's running partials
      cls_tile<DH>(ks, vs, qt, t_frames, cq, scale,
                   cpart + (j & 1) * nw * (DH + 2) + warp * (DH + 2), qt == warp);
    }
  }
  __syncthreads();
  if (count > 0 && warp == nw - 1)
    merge(item_of(count - 1), cpart + ((count - 1) & 1) * nw * (DH + 2));
}

// The bf16 kernel's cut: persistent blocks, warps a block, item slots in a
// block's ring, dynamic shared memory a block and blocks an SM.
struct Plan {
  int blocks, warps, stages, per_sm;
  size_t bytes;
};

template <int DH>
cudaError_t plan_bf16(int t_frames, long long items, Plan& p) {
  if (t_frames < 1 || t_frames > MAX_T || items < 1 || items > INT_MAX)
    return cudaErrorInvalidValue;
  const int tiles = pad16(t_frames) / 16;
  p.warps = tiles < WARPS ? tiles : WARPS;
  p.stages = STAGES;
  p.bytes = bf16_smem_bytes<DH>(pad16(t_frames), p.warps);
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(headgrid_bf16_kernel<DH>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, headgrid_bf16_kernel<DH>,
                                                           p.warps * 32, p.bytes)) != cudaSuccess)
    return err;
  if (p.per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)p.per_sm * sms;
  p.blocks = (int)(items < cap ? items : cap);
  return cudaSuccess;
}

// ---------------------------------------------------------------- f32

template <int DH>
size_t f32_smem_bytes(int t_frames) {
  return 4 * (2 * (size_t)t_frames * DH + 3 * DH + t_frames + 32);
}

// The CLS query's partials over the tube's keys (staged rows [T][DH] f32),
// written at pidx; every thread of the block calls it.
template <int DH>
__device__ void cls_partials_f32(const float* ks, const float* vs, const float* cqs, float* pl,
                                 float* red, int t_frames, float scale, long pidx,
                                 float* part_m, float* part_s, float* part_co) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  float mx = -CUDART_INF_F;
  for (int j = tid; j < t_frames; j += nthr) {
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) dot += cqs[c] * ks[j * DH + c];
    pl[j] = scale * dot;
    mx = fmaxf(mx, pl[j]);
  }
  mx = block_reduce(mx, true, red);
  float sum = 0.f;
  for (int j = tid; j < t_frames; j += nthr) {
    const float e = expf(pl[j] - mx);
    pl[j] = e;
    sum += e;
  }
  sum = block_reduce(sum, false, red);  // its barriers also publish pl
  for (int c = tid; c < DH; c += nthr) {
    float co = 0.f;
    for (int j = 0; j < t_frames; ++j) co += pl[j] * vs[j * DH + c];
    part_co[pidx * DH + c] = co;
  }
  if (tid == 0) {
    part_m[pidx] = mx;
    part_s[pidx] = sum;
  }
}

template <int DH>
__global__ void __launch_bounds__(MAX_T)
headgrid_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ cls_q,
                    const float* __restrict__ cls_k, const float* __restrict__ cls_v,
                    float* __restrict__ out, float* __restrict__ part_m, float* __restrict__ part_s,
                    float* __restrict__ part_co, int t_frames, int n_patches, int heads,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [T][DH]
  float* vs = ks + t_frames * DH;              // [T][DH]
  float* cks = vs + t_frames * DH;
  float* cvs = cks + DH;
  float* cqs = cvs + DH;
  float* pl = cqs + DH;  // [T]
  float* red = pl + t_frames;

  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long d = (long)heads * DH, d3 = 3 * d;
  const long hcol = (long)h * DH;
  const long rstride = (long)n_patches * d3;
  const float* tube = qkv + ((long)b * t_frames * n_patches + n) * d3 + hcol;

  for (int idx = tid; idx < t_frames * DH; idx += nthr) {
    const int j = idx / DH, c = idx % DH;
    ks[idx] = tube[j * rstride + d + c];
    vs[idx] = tube[j * rstride + 2 * d + c];
  }
  const long cls_off = (long)b * d + hcol;
  for (int c = tid; c < DH; c += nthr) {
    cks[c] = cls_k[cls_off + c];
    cvs[c] = cls_v[cls_off + c];
    cqs[c] = cls_q[cls_off + c];
  }
  __syncthreads();

  const bool active = tid < t_frames;
  {
    // an idle thread computes on frame 0 and writes nothing
    const float* src = tube + (active ? tid : 0) * rstride;
    float q[DH], acc[DH];
    float lc = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      q[c] = src[c];
      lc += q[c] * cks[c];
    }
    float m = scale * lc, l = 1.f;  // the CLS key opens the running softmax
#pragma unroll
    for (int c = 0; c < DH; ++c) acc[c] = cvs[c];
    for (int j0 = 0; j0 < t_frames; j0 += JC) {
      float s[JC];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = j0 + jj;
        float logit = -CUDART_INF_F;
        if (j < t_frames) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < DH; ++c) dot += q[c] * ks[j * DH + c];
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
        if (j < t_frames) {
          const float p = expf(s[jj] - m);
          l += p;
#pragma unroll
          for (int c = 0; c < DH; ++c) acc[c] += p * vs[j * DH + c];
        }
      }
    }
    if (active) {
      float* dst = out + (((long)b * t_frames + tid) * n_patches + n) * d + hcol;
#pragma unroll
      for (int c = 0; c < DH; ++c) dst[c] = acc[c] / l;
    }
  }

  const long pidx = ((long)b * n_patches + n) * heads + h;
  cls_partials_f32<DH>(ks, vs, cqs, pl, red, t_frames, scale, pidx, part_m, part_s, part_co);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DH>
int launch(const void* qkv, const void* cls_q, const void* cls_k, const void* cls_v, void* out,
           void* part_m, void* part_s, void* part_co, int batch, int t_frames, int n_patches,
           int heads, int is_bf16, float scale, cudaStream_t stream) {
  if (t_frames < 1 || t_frames > MAX_T || n_patches < 1 || batch < 1 || batch > 65535 ||
      heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (is_bf16) {
    const long long items = (long long)batch * n_patches * heads;
    Plan p;
    if ((err = plan_bf16<DH>(t_frames, items, p)) != cudaSuccess) return (int)err;
    headgrid_bf16_kernel<DH><<<p.blocks, p.warps * 32, p.bytes, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(cls_q),
        static_cast<const bf16*>(cls_k), static_cast<const bf16*>(cls_v), static_cast<bf16*>(out),
        static_cast<float*>(part_m), static_cast<float*>(part_s), static_cast<float*>(part_co),
        t_frames, n_patches, heads, (int)items, scale);
  } else {
    const dim3 grid(n_patches, heads, batch);
    const size_t bytes = f32_smem_bytes<DH>(t_frames);
    if ((err = allow_smem(headgrid_f32_kernel<DH>, bytes)) != cudaSuccess) return (int)err;
    headgrid_f32_kernel<DH><<<grid, (t_frames + 31) / 32 * 32, bytes, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(cls_q),
        static_cast<const float*>(cls_k), static_cast<const float*>(cls_v),
        static_cast<float*>(out), static_cast<float*>(part_m), static_cast<float*>(part_s),
        static_cast<float*>(part_co), t_frames, n_patches, heads, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. head_dim is 32 or 64;
// is_bf16 selects bf16 (1) or f32 (0) for qkv, the CLS rows and out. qkv
// and the CLS rows start on 16-byte boundaries (the wrapper checks).
// Partials are (B, N, H, 1|1|head_dim) f32.
extern "C" int hh_time_attention_headgrid(const void* qkv, const void* cls_q, const void* cls_k,
                                          const void* cls_v, void* out, void* part_m,
                                          void* part_s, void* part_co, int batch, int t_frames,
                                          int n_patches, int heads, int head_dim, int is_bf16,
                                          float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch<64>(qkv, cls_q, cls_k, cls_v, out, part_m, part_s, part_co, batch, t_frames,
                      n_patches, heads, is_bf16, scale, st);
  if (head_dim == 32)
    return launch<32>(qkv, cls_q, cls_k, cls_v, out, part_m, part_s, part_co, batch, t_frames,
                      n_patches, heads, is_bf16, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's cut for T frames and `items` = B * N * H (reported by
// chip_smoke.py): plan = {persistent blocks, warps a block, item slots a
// block, dynamic shared memory bytes a block, blocks an SM}. Returns 0 or a
// cudaError_t.
extern "C" int hh_time_attention_headgrid_plan(int t_frames, long long items, int head_dim,
                                               long long* plan) {
  Plan p;
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64) err = plan_bf16<64>(t_frames, items, p);
  if (head_dim == 32) err = plan_bf16<32>(t_frames, items, p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.blocks;
  plan[1] = p.warps;
  plan[2] = p.stages;
  plan[3] = (long long)p.bytes;
  plan[4] = p.per_sm;
  return 0;
}
