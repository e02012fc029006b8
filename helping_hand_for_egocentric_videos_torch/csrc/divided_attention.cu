// Divided space-time attention on packed qkv, for Hopper (sm_90a).
//
// Replaces: helping_hand_for_egocentric_videos_tpu/ops/divided_attention.py,
// `_rows_kernel` as `divided_patch_attention` calls it in mode `space`
// (K1) and mode `time` (K2), and with `quant_out` (K3).
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
// 35 us at the bf16 tensor-core rate but 0.5 ms at the 67 TFLOP/s f32
// CUDA-core peak: so the bf16 products run on the tensor cores, and both
// modes are then bound by bytes. Time mode does (T+1)/(N+1) as much
// arithmetic.
//
// bf16 design. The TPU kernel's block-diagonal packing of tubes and its
// sequential grid do not carry over. A block owns one group and `hb`
// neighbouring heads (hb > 1 only where a group has fewer than 4 query
// tiles, as K2's 16-frame tubes: 4 heads make 512-byte runs of each row).
//   - It stages the group's keys and values of its heads in shared memory
//     once, as bf16, with 16-byte cp.async copies (rows padded by 8 bf16 so
//     that ldmatrix hits 32 distinct banks), in groups of 64 keys: the warps
//     start on the first 64 while the rest arrive. Where they do not fit
//     (space N > ~700), it streams 64-key tiles through two slots instead,
//     once for every pass of its warps over the query tiles.
//   - Each warp takes 16-query tiles (head, tile) in turn. It copies the
//     tile's q rows to a shared-memory buffer of its own and loads them as
//     mma fragments with ldmatrix; QK^T and PV run on mma.sync m16n8k16
//     (bf16 in, f32 sums) over 64-key steps with an f32 online softmax opened
//     by the CLS key (its logit and value in f32 on the CUDA cores); the
//     exponentials are 2^x on the special-function unit with DH^-0.5 log2(e)
//     folded into one multiply-add a logit. The probabilities enter PV
//     rounded to bf16, as on the TPU (`e_p.astype` into its PV dot); the
//     denominator is the f32 sum. The key fragments come from row-major keys
//     with ldmatrix, the value fragments from row-major values with
//     ldmatrix.trans.
//   - The output is stored from the fragments: the 4 lanes of a row write
//     16 neighbouring bytes of bf16 (32 of K3's f32), and a warp's stores
//     cover its rows' 128-byte head slices whole. (Staging it through the
//     warp's buffer as 16-byte rows measured the same.)
//   - The CLS partials come from the staged rows in the same block: each
//     warp runs an f32 online softmax of the CLS query over a slice of the
//     group's keys (a lane a key for the logits, a lane a column pair for
//     the weighted values), and one warp a head merges the slices.
// f32 design (a test and debug type): one thread a query row on the CUDA
// cores, q and the running output in registers, keys and values staged in
// f32 tiles of 64; tile 0 of each group computes the CLS partials.
//
// K3 (`quant_out=True` of the same TPU kernel, replaces its in-VMEM
// quantization of the output rows). The TPU program holds all heads of its
// rows and takes max|row| over D; here a block holds one head (or a few), so
// no block sees a whole row. K3 therefore runs in two launches: this kernel
// writes the normalized per-head output in f32 to a (B, T, N, D) scratch
// (the scale must come from the f32 output, before any bf16 rounding), then
// row_quant.cuh's row kernel, the code K4 and K5 use, takes max|row| over all
// heads and writes the int8 codes and f32 scales. Its CLS partials are K1's
// and K2's bit for bit: the same code computes them. Its probabilities enter
// PV as two bf16 terms, the rounded value and what the rounding left out
// (about 16 bits together; a second PV product), so its f32 rows keep f32
// precision: a scale is a max over the row, and one probability of its
// largest value rounded the other way moves it by about 1e-3, where K3's
// contract with the plain version allows 1e-5. Its softmax steps are 32 keys,
// not 64, so that the second product fits in 128 registers without spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "attention_mma.cuh"
#include "row_quant.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

constexpr int MAX_W = 1024;  // largest group

// ---------------------------------------------------------------- bf16

constexpr int WARPS = 8;       // most warps a block
constexpr int PACK_WARPS = 4;  // heads share a block while their tiles fill this many warps
constexpr int KC = 64;         // keys an online-softmax step and a streamed tile
constexpr int PAD = 8;         // bf16 padding of a shared-memory row

__host__ __device__ constexpr int pad16(int w) { return (w + 15) & ~15; }

// K and V of hb heads (kv_rows rows a head), the warps' q buffers, the
// CLS key, value and query of hb heads and the warps' CLS slices.
template <int DH>
size_t bf16_smem_bytes(int hb, int kv_rows, int nw) {
  constexpr int RS = DH + PAD;
  return 2 * (2 * (size_t)hb * kv_rows * RS + (size_t)nw * 16 * RS) +
         4 * (3 * (size_t)hb * DH + (size_t)nw * (DH + 2));
}

// The CLS query's f32 online softmax over nk staged rows (kr keys, vr
// values, row stride DH + PAD): a lane a key for the logits, a lane
// DH / 32 columns for the weighted values. cm, cs, co carry the running
// max, sum and weighted values (every lane holds cm and cs).
template <int DH>
__device__ __forceinline__ void cls_rows(const bf16* kr, const bf16* vr, int nk, const float* cq,
                                         float scale, float& cm, float& cs,
                                         float (&co)[DH / 32]) {
  constexpr int RS = DH + PAD, CPL = DH / 32;
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < nk; r0 += 32) {  // warp-uniform
    const int key = r0 + lane;
    float lg = -CUDART_INF_F;
    if (key < nk) {
      const bf16* kp = kr + key * RS;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(kp + c);
        dot += dot_pair(u.x, cq + c) + dot_pair(u.y, cq + c + 2) + dot_pair(u.z, cq + c + 4) +
               dot_pair(u.w, cq + c + 6);
      }
      lg = scale * dot;
    }
    const float mn = fmaxf(cm, warp_max(lg));  // finite: key r0 is in range
    const float corr = expf(cm - mn);
    const float p = key < nk ? expf(lg - mn) : 0.f;
    cs = cs * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < CPL; ++i) co[i] *= corr;
    const int nr = min(32, nk - r0);
    for (int kk = 0; kk < nr; ++kk) {
      const float pk = __shfl_sync(FULL, p, kk);
      const bf16* vp = vr + (r0 + kk) * RS + lane * CPL;
      if constexpr (CPL == 2) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp));
        co[0] += pk * f.x;
        co[1] += pk * f.y;
      } else {
        co[0] += pk * to_f32(*vp);
      }
    }
    cm = mn;
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// TO = bf16: the attention output (K1, K2); TO = float: K3's f32 rows.
template <typename TO, int DH>
__global__ void __launch_bounds__(WARPS * 32)
attention_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ cls_q,
                      const bf16* __restrict__ cls_k, const bf16* __restrict__ cls_v,
                      TO* __restrict__ out, float* __restrict__ part_m, float* __restrict__ part_s,
                      float* __restrict__ part_co, int t_frames, int n_patches, int heads,
                      int time_mode, int hb, int streamed, float scale) {
  constexpr int RS = DH + PAD, CH = DH / 8, CPL = DH / 32;
  constexpr bool F32_ROWS = sizeof(TO) == 4;  // K3
  // keys an online-softmax step: K3's second PV product holds more registers
  constexpr int KS = F32_ROWS ? 32 : KC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int g4 = lane >> 2, tq = lane & 3;  // mma fragment row group, column pair
  const int hblocks = heads / hb;
  const long g = blockIdx.x / hblocks;
  const int h0 = (blockIdx.x % hblocks) * hb;
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
  const int wp = pad16(w), tiles = wp / 16;
  const int kv_rows = streamed ? 2 * KC : wp;
  bf16* ks = reinterpret_cast<bf16*>(smem);                      // [hb][kv_rows][RS]
  bf16* vs = ks + hb * kv_rows * RS;                             // [hb][kv_rows][RS]
  bf16* qb = vs + hb * kv_rows * RS + warp * 16 * RS;            // this warp's [16][RS]
  float* ckf = reinterpret_cast<float*>(vs + hb * kv_rows * RS + nw * 16 * RS);  // [hb][DH]
  float* cvf = ckf + hb * DH;                                    // [hb][DH]
  float* cqf = cvf + hb * DH;                                    // [hb][DH]
  float* cpart = cqf + hb * DH;                                  // [nw][DH + 2]

  // group rows k0 .. k0 + nrows (zeros past w) of hb heads -> kv rows dst ..
  auto stage_kv = [&](int k0, int nrows, int dst) {
    const int per_row = hb * CH;
    for (int idx = tid; idx < nrows * per_row; idx += blockDim.x) {
      const int r = idx / per_row, rem = idx - r * per_row, j = rem / CH, c = (rem - j * CH) * 8;
      const int key = k0 + r;
      const bool ok = key < w;
      const bf16* src = qkv + (row0 + (long)(ok ? key : 0) * rstride) * d3 + (long)(h0 + j) * DH + c;
      const int o = (j * kv_rows + dst + r) * RS + c;
      cp_async16(ks + o, src + d, ok);
      cp_async16(vs + o, src + 2 * d, ok);
    }
  };

  const int items = hb * tiles;  // (head, query tile) pairs
  const int passes = (items + nw - 1) / nw;
  // this warp's q rows of pass p (zeros past w) -> its buffer; one group
  auto stage_q = [&](int p) {
    const int item = p * nw + warp;
    if (item < items) {
      const int qt = item % tiles;
      const long hcol = (long)(h0 + item / tiles) * DH;
      for (int idx = lane; idx < 16 * CH; idx += 32) {
        const int r = idx / CH, c = (idx % CH) * 8, qi = qt * 16 + r;
        const bool ok = qi < w;
        cp_async16(qb + r * RS + c, qkv + (row0 + (long)(ok ? qi : 0) * rstride) * d3 + hcol + c, ok);
      }
    }
    cp_async_commit();
  };

  // resident: pass 0's q, then the keys and values in groups of KC rows, so
  // that pass 0 starts on the first KC keys while the rest arrive;
  // streamed: the first tile, then the q
  if (!streamed) {
    stage_q(0);
    for (int k0 = 0; k0 < wp; k0 += KC) {
      stage_kv(k0, min(KC, wp - k0), k0);
      cp_async_commit();
    }
  } else {
    stage_kv(0, KC, 0);
    cp_async_commit();
    stage_q(0);
  }
  const int chunks = (wp + KC - 1) / KC;
  {
    const long off = b * d + (long)h0 * DH;  // the block's heads are neighbours
    for (int i = tid; i < hb * DH; i += blockDim.x) {
      ckf[i] = to_f32(cls_k[off + i]);
      cvf[i] = to_f32(cls_v[off + i]);
      cqf[i] = to_f32(cls_q[off + i]);
    }
  }

  // this warp's slice of the CLS query's keys: head jc, slice sl of `slices`
  const int slices = nw / hb;
  const int jc = warp / slices, sl = warp % slices;
  float cm = -CUDART_INF_F, cs = 0.f, cco[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) cco[i] = 0.f;

  const float sl2 = scale * 1.4426950408889634f;  // exp(scale * x) = 2^(sl2 * x)
  int it = 0;  // streamed: tiles consumed so far; tile it sits in slot it & 1
  for (int pass = 0; pass < passes; ++pass) {
    const int item = pass * nw + warp;
    const bool active = item < items;
    const int j = active ? item / tiles : 0, qt = active ? item % tiles : 0;
    const long hcol = (long)(h0 + j) * DH;
    if (pass > 0) {
      stage_q(pass);
      if (!streamed) {  // every key is in since pass 0
        cp_async_wait_all();
        __syncwarp();
      }
    }

    uint32_t qa[DH / 16][4];
    float m0 = 0.f, m1 = 0.f, l0 = 0.f, l1 = 0.f;
    float o[DH / 8][4];
    for (int k0 = 0; k0 < w; k0 += KC) {
      const bf16 *kt, *vt;  // key k0's staged rows of head j
      if (streamed) {       // block-uniform; every warp takes part
        cp_async_wait_all();
        __syncthreads();    // tile it (and q) is in; slot (it + 1) & 1 is free
        const int nxt = (it + 1) & 1;
        if (k0 + KC < w) stage_kv(k0 + KC, KC, nxt * KC);
        else if (pass + 1 < passes) stage_kv(0, KC, nxt * KC);
        cp_async_commit();
        kt = ks + (it & 1) * KC * RS;
        vt = vs + (it & 1) * KC * RS;
        ++it;
        if (pass == 0) {  // the CLS query's slice of this tile
          const int per = (KC + nw - 1) / nw, ks0 = warp * per;
          cls_rows<DH>(kt + ks0 * RS, vt + ks0 * RS, min(per, min(KC, w - k0) - ks0), cqf, scale,
                       cm, cs, cco);
        }
      } else {
        if (pass == 0) {  // block-uniform; every warp has a tile in pass 0
          cp_async_wait_pending(chunks - 1 - k0 / KC);  // q and keys up to k0 + KC are in
          __syncthreads();
        }
        kt = ks + (j * kv_rows + k0) * RS;
        vt = vs + (j * kv_rows + k0) * RS;
      }
      if (!active) continue;

      if (k0 == 0) {
        // q fragments; the CLS key's logit and value open the running softmax
        const float* ck = ckf + j * DH;
        const float* cv = cvf + j * DH;
        float lc0 = 0.f, lc1 = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          ldsm_x4(qa[kk], qb + (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + kk * 16 +
                              ((lane >> 4) & 1) * 8);
          const int c = kk * 16 + tq * 2;
          lc0 += dot_pair(qa[kk][0], ck + c) + dot_pair(qa[kk][2], ck + c + 8);
          lc1 += dot_pair(qa[kk][1], ck + c) + dot_pair(qa[kk][3], ck + c + 8);
        }
        lc0 += __shfl_xor_sync(FULL, lc0, 1);
        lc0 += __shfl_xor_sync(FULL, lc0, 2);
        lc1 += __shfl_xor_sync(FULL, lc1, 1);
        lc1 += __shfl_xor_sync(FULL, lc1, 2);
        // m = the CLS logit (unscaled, as every m below), weight 1 (held
        // once a row, by column pair 0)
        m0 = lc0;
        m1 = lc1;
        l0 = l1 = tq == 0 ? 1.f : 0.f;
        __syncwarp();  // every lane holds its q fragments: the buffer may take the next q
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt) {
          const int c = nt * 8 + tq * 2;
          o[nt][0] = o[nt][2] = cv[c];
          o[nt][1] = o[nt][3] = cv[c + 1];
        }
      }

      // online-softmax steps of KS keys over this tile (one step but for K3)
#pragma unroll
      for (int sub = 0; sub < KC; sub += KS) {
        const int ks0 = k0 + sub;
        if (ks0 >= w) break;  // warp-uniform
        const bf16* kq = kt + sub * RS;
        const bf16* vq = vt + sub * RS;
        // S = Q K^T over keys ks0 .. ks0 + KS, 16 keys (two n-tiles) a load
        float s[KS / 8][4];
#pragma unroll
        for (int np = 0; np < KS / 16; ++np) {
          s[2 * np][0] = s[2 * np][1] = s[2 * np][2] = s[2 * np][3] = 0.f;
          s[2 * np + 1][0] = s[2 * np + 1][1] = s[2 * np + 1][2] = s[2 * np + 1][3] = 0.f;
          if (ks0 + np * 16 < wp) {  // warp-uniform
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk) {
              uint32_t kb[4];
              ldsm_x4(kb, kq + (np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * RS + kk * 16 +
                              ((lane >> 3) & 1) * 8);
              mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
              mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int nt = 0; nt < KS / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = ks0 + nt * 8 + tq * 2 + (e & 1);
            const float v = key < w ? s[nt][e] : -CUDART_INF_F;
            s[nt][e] = v;
            if (e < 2) mx0 = fmaxf(mx0, v);
            else mx1 = fmaxf(mx1, v);
          }
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
        for (int nt = 0; nt < KS / 8; ++nt) {
          s[nt][0] = fast_exp2(fmaf(s[nt][0], sl2, -ms0));
          s[nt][1] = fast_exp2(fmaf(s[nt][1], sl2, -ms0));
          s[nt][2] = fast_exp2(fmaf(s[nt][2], sl2, -ms1));
          s[nt][3] = fast_exp2(fmaf(s[nt][3], sl2, -ms1));
          l0 += s[nt][0] + s[nt][1];
          l1 += s[nt][2] + s[nt][3];
        }
        // O += P V, 16 keys a step: two logits tiles make one A fragment
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
          if (ks0 + kk * 16 < wp) {  // warp-uniform
            uint32_t pa[4], pr[4];  // P in bf16; K3: and what its rounding left out
            split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pr[0]);
            split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pr[1]);
            split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pr[2]);
            split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pr[3]);
#pragma unroll
            for (int dp = 0; dp < DH / 16; ++dp) {
              uint32_t vb[4];
              ldsm_x4_trans(vb, vq + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS + dp * 16 +
                                    ((lane >> 4) & 1) * 8);
              mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
              mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
              if constexpr (F32_ROWS) {
                mma_bf16(o[2 * dp], pr, vb[0], vb[1]);
                mma_bf16(o[2 * dp + 1], pr, vb[2], vb[3]);
              }
            }
          }
        }
      }
    }
    if (!active) continue;

    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const int r0 = qt * 16 + g4, r1 = r0 + 8;
    TO* o0 = out + (row0 + (long)r0 * rstride) * d + hcol;
    TO* o1 = out + (row0 + (long)r1 * rstride) * d + hcol;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int c = nt * 8 + tq * 2;
      if (r0 < w) store_pair(o0 + c, o[nt][0] / l0, o[nt][1] / l0);
      if (r1 < w) store_pair(o1 + c, o[nt][2] / l1, o[nt][3] / l1);
    }
  }

  // CLS partials: resident rows give each warp its slice now; then one warp
  // a head merges its heads' slices
  if (!streamed) {
    const int per = (w + slices - 1) / slices, k0 = sl * per;
    const bf16* kr = ks + (jc * kv_rows + k0) * RS;
    const bf16* vr = vs + (jc * kv_rows + k0) * RS;
    cls_rows<DH>(kr, vr, min(per, w - k0), cqf + jc * DH, scale, cm, cs, cco);
  }
  float* mine = cpart + warp * (DH + 2);
  if (lane == 0) {
    mine[0] = cm;
    mine[1] = cs;
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) mine[2 + lane * CPL + i] = cco[i];
  __syncthreads();
  if (warp < hb) {
    const float* first = cpart + warp * slices * (DH + 2);
    float mg = -CUDART_INF_F;
    for (int i = 0; i < slices; ++i) mg = fmaxf(mg, first[i * (DH + 2)]);
    float sg = 0.f, cg[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) cg[i] = 0.f;
    for (int i = 0; i < slices; ++i) {
      const float* p = first + i * (DH + 2);
      const float wt = expf(p[0] - mg);  // an empty slice: exp(-inf) = 0
      sg += p[1] * wt;
#pragma unroll
      for (int c = 0; c < CPL; ++c) cg[c] += p[2 + lane * CPL + c] * wt;
    }
    const long pidx = g * heads + h0 + warp;
#pragma unroll
    for (int c = 0; c < CPL; ++c) part_co[pidx * DH + lane * CPL + c] = cg[c];
    if (lane == 0) {
      part_m[pidx] = mg;
      part_s[pidx] = sg;
    }
  }
}

// How a group of w rows is cut: heads a block, warps a block, whether its
// keys and values are streamed, and the dynamic shared memory a block.
struct Plan {
  int hb, nw, streamed;
  size_t bytes;
};

template <int DH>
cudaError_t plan_bf16(int w, int heads, Plan& p) {
  if (w < 1 || w > MAX_W || heads < 1) return cudaErrorInvalidValue;
  const int tiles = pad16(w) / 16;
  p.hb = 1;  // pack short groups' heads into a block, up to PACK_WARPS warps
  for (int c = PACK_WARPS / tiles; c > 1; --c) {
    if (heads % c == 0) {
      p.hb = c;
      break;
    }
  }
  p.nw = p.hb > 1 ? p.hb * tiles : (tiles < WARPS ? tiles : WARPS);
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  p.streamed = 0;
  p.bytes = bf16_smem_bytes<DH>(p.hb, pad16(w), p.nw);
  if (p.bytes > (size_t)optin) {  // the group's rows do not fit: stream them
    if (p.hb != 1) return cudaErrorInvalidValue;
    p.streamed = 1;
    p.bytes = bf16_smem_bytes<DH>(1, 2 * KC, p.nw);
  }
  return cudaSuccess;
}

template <typename TO, int DH>
int launch_bf16(const void* qkv, const void* cls_q, const void* cls_k, const void* cls_v,
                void* out, void* part_m, void* part_s, void* part_co, int batch, int t_frames,
                int n_patches, int heads, int time_mode, float scale, cudaStream_t stream) {
  const long groups = (long)batch * (time_mode ? n_patches : t_frames);
  Plan p;
  cudaError_t err = plan_bf16<DH>(time_mode ? t_frames : n_patches, heads, p);
  if (err != cudaSuccess) return (int)err;
  const long nblocks = groups * (heads / p.hb);
  if (groups < 1 || nblocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(attention_bf16_kernel<TO, DH>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes)) !=
      cudaSuccess)
    return (int)err;
  attention_bf16_kernel<TO, DH><<<(unsigned)nblocks, p.nw * 32, p.bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(cls_q),
      static_cast<const bf16*>(cls_k), static_cast<const bf16*>(cls_v), static_cast<TO*>(out),
      static_cast<float*>(part_m), static_cast<float*>(part_s), static_cast<float*>(part_co),
      t_frames, n_patches, heads, time_mode, p.hb, p.streamed, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- f32

constexpr int KT = 64;      // keys staged in shared memory per tile
constexpr int MAX_QT = 64;  // queries (threads) per block
constexpr int JC = 16;      // keys per online-softmax rescale

template <int DH>
__global__ void __launch_bounds__(MAX_QT)
attention_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ cls_q,
                     const float* __restrict__ cls_k, const float* __restrict__ cls_v,
                     float* __restrict__ out, float* __restrict__ part_m,
                     float* __restrict__ part_s, float* __restrict__ part_co, int t_frames,
                     int n_patches, int heads, int time_mode, float scale) {
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
    cs[c] = cls_k[cls_off + c];
    cvs[c] = cls_v[cls_off + c];
  }
  __syncthreads();

  const int qi = blockIdx.x * nthr + tid;
  const bool active = qi < w;
  float q[DH], acc[DH];
  float m, l;
  {
    // an idle thread computes on row 0 of the group and writes nothing
    const float* src = qkv + (row0 + (long)(active ? qi : 0) * rstride) * d3 + hcol;
    float lc = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      q[c] = src[c];
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
      const float* row = qkv + (row0 + (long)(k0 + j) * rstride) * d3 + hcol + c;
      ks[j][c] = row[d];
      vs[j][c] = row[2 * d];
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
    float* dst = out + (row0 + (long)qi * rstride) * d + hcol;
#pragma unroll
    for (int c = 0; c < DH; ++c) dst[c] = acc[c] / l;
  }

  if (blockIdx.x != 0) return;  // block-uniform: tile 0 owns the CLS partials

  __syncthreads();  // every thread is done reading cs
  for (int c = tid; c < DH; c += nthr) cs[c] = cls_q[cls_off + c];
  __syncthreads();
  float mx = -CUDART_INF_F;
  for (int j = tid; j < w; j += nthr) {
    const float* krow = qkv + (row0 + (long)j * rstride) * d3 + d + hcol;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) dot += cs[c] * krow[c];
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
    const float* vcol = qkv + row0 * d3 + 2 * d + hcol + c;
    float co = 0.f;
    for (int j = 0; j < w; ++j) co += ps[j] * vcol[(long)j * rstride * d3];
    part_co[pidx * DH + c] = co;
  }
  if (tid == 0) {
    part_m[pidx] = mx;
    part_s[pidx] = sum;
  }
}

template <int DH>
int launch_f32(const void* qkv, const void* cls_q, const void* cls_k, const void* cls_v,
               void* out, void* part_m, void* part_s, void* part_co, int batch, int t_frames,
               int n_patches, int heads, int time_mode, float scale, cudaStream_t stream) {
  const int w = time_mode ? t_frames : n_patches;
  const long groups = (long)batch * (time_mode ? n_patches : t_frames);
  if (w < 1 || w > MAX_W || groups < 1 || groups > 65535 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int nthr = w >= MAX_QT ? MAX_QT : ((w + 31) / 32) * 32;
  const dim3 grid((w + nthr - 1) / nthr, heads, (unsigned)groups);
  attention_f32_kernel<DH><<<grid, nthr, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(cls_q),
      static_cast<const float*>(cls_k), static_cast<const float*>(cls_v),
      static_cast<float*>(out), static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<float*>(part_co), t_frames, n_patches, heads, time_mode, scale);
  return (int)cudaGetLastError();
}

// TO: the output type of bf16 inputs (bf16 for K1/K2, float for K3's rows);
// f32 inputs always write f32.
template <typename TO>
int launch(const void* qkv, const void* cls_q, const void* cls_k, const void* cls_v, void* out,
           void* part_m, void* part_s, void* part_co, int batch, int t_frames, int n_patches,
           int heads, int head_dim, int time_mode, int is_bf16, float scale, cudaStream_t st) {
#define HH_ARGS                                                                          \
  qkv, cls_q, cls_k, cls_v, out, part_m, part_s, part_co, batch, t_frames, n_patches, heads, \
      time_mode, scale, st
  if (is_bf16) {
    if (head_dim == 64) return launch_bf16<TO, 64>(HH_ARGS);
    if (head_dim == 32) return launch_bf16<TO, 32>(HH_ARGS);
  } else {
    if (head_dim == 64) return launch_f32<64>(HH_ARGS);
    if (head_dim == 32) return launch_f32<32>(HH_ARGS);
  }
#undef HH_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. head_dim is 32 or 64;
// is_bf16 selects bf16 (1) or f32 (0) for qkv, the CLS rows and out. qkv
// and out are 16-byte aligned (the wrapper checks qkv).
extern "C" int hh_divided_attention(const void* qkv, const void* cls_q, const void* cls_k,
                                    const void* cls_v, void* out, void* part_m, void* part_s,
                                    void* part_co, int batch, int t_frames, int n_patches,
                                    int heads, int head_dim, int time_mode, int is_bf16,
                                    float scale, void* stream) {
  return launch<bf16>(qkv, cls_q, cls_k, cls_v, out, part_m, part_s, part_co, batch, t_frames,
                      n_patches, heads, head_dim, time_mode, is_bf16, scale,
                      static_cast<cudaStream_t>(stream));
}

// The bf16 kernel's cut of a group of w rows (reported by chip_smoke.py):
// plan = {heads a block, warps a block, streamed (0|1), dynamic shared
// memory bytes a block}. Returns 0 or a cudaError_t.
extern "C" int hh_divided_attention_plan(int w, int heads, int head_dim, long long* plan) {
  Plan p;
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64) err = plan_bf16<64>(w, heads, p);
  if (head_dim == 32) err = plan_bf16<32>(w, heads, p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.hb;
  plan[1] = p.nw;
  plan[2] = p.streamed;
  plan[3] = (long long)p.bytes;
  return 0;
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
  const int rc = launch<float>(qkv, cls_q, cls_k, cls_v, rows, part_m, part_s, part_co, batch,
                               t_frames, n_patches, heads, head_dim, time_mode, is_bf16, scale, st);
  if (rc != 0) return rc;
  return rowq::launch_rows<rowq::RowOp::kIdentity>(
      static_cast<const float*>(rows), nullptr, nullptr, static_cast<int8_t*>(codes),
      static_cast<float*>(scales), (long long)batch * t_frames * n_patches, heads * head_dim,
      0.f, st);
}
