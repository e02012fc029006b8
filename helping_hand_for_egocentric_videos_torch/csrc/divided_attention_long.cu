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
// Here a block reads the packed qkv at its strides and writes (B, T, N, D)
// directly: no transpose pass, no masked products.
//
// Bound. At B = 1, T = 128, N = 256, D = 1024, bf16: 201 MB of qkv in and 67
// MB out, 80 us at 3.35 TB/s; 4*T*N*H*DH*(T+2) = 17.4 GFLOP of products, 18
// us on bf16 tensor cores, 260 us at the 67 TFLOP/s f32 CUDA-core peak. So
// the bf16 products go to the tensor cores, and the kernel is then bound by
// its bytes.
//
// Design. One block owns one (b, tube, head). It stages the tube's T keys
// (row-major) and values (transposed) of that head once in shared memory
// (T = 128, DH = 64, bf16: 36 KB with the padding), and computes the CLS
// partials from them in the same block.
//   bf16: up to 8 warps; a warp owns 16 queries at a time, its q fragments in
//         registers, and runs mma.sync m16n8k16 (bf16 in, f32 sums) for
//         Q K^T and P V over 64-key steps with an f32 online softmax opened
//         by the CLS key (its logit and value in f32 on the CUDA cores). The
//         probabilities enter P V rounded to bf16, as on the TPU; the sums
//         of the softmax stay f32. Rows are padded by 8 bf16 so the
//         fragment loads hit 32 distinct banks.
//   f32:  one thread a query on the CUDA cores (q and the running output in
//         registers), keys and values staged in f32; a debug and test type.
// T <= 256 and DH in {32, 64}; the wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int MAX_T = 256;
constexpr int WARPS = 8;  // bf16: warps a block, each on 16-query tiles
constexpr int KC = 64;    // bf16: keys per online-softmax step
constexpr int PAD = 8;    // bf16: padding of a shared-memory row
constexpr int JC = 16;    // f32: keys per online-softmax rescale

// The CLS query's partials over the tube's keys (k_at(j, c), v_at(j, c) read
// the staged rows), written at pidx; every thread of the block calls it.
template <int DH, class KAt, class VAt>
__device__ void cls_partials(KAt k_at, VAt v_at, const float* cqs, float* pl, float* red,
                             int t_frames, float scale, long pidx, float* part_m,
                             float* part_s, float* part_co) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  float mx = -CUDART_INF_F;
  for (int j = tid; j < t_frames; j += nthr) {
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) dot += cqs[c] * k_at(j, c);
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
    for (int j = 0; j < t_frames; ++j) co += pl[j] * v_at(j, c);
    part_co[pidx * DH + c] = co;
  }
  if (tid == 0) {
    part_m[pidx] = mx;
    part_s[pidx] = sum;
  }
}

__host__ __device__ constexpr int pad16(int t) { return (t + 15) & ~15; }

template <int DH>
size_t bf16_smem_bytes(int t_frames) {
  const int tp = pad16(t_frames);
  return 2 * ((size_t)tp * (DH + PAD) + (size_t)DH * (tp + PAD)) + 4 * (3 * DH + tp + 32);
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
headgrid_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ cls_q,
                     const __nv_bfloat16* __restrict__ cls_k, const __nv_bfloat16* __restrict__ cls_v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ part_m,
                     float* __restrict__ part_s, float* __restrict__ part_co, int t_frames,
                     int n_patches, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tp = pad16(t_frames);  // keys padded to the mma depth, zero-filled
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [tp][DH + PAD]
  __nv_bfloat16* vt = ks + tp * (DH + PAD);                      // [DH][tp + PAD]
  float* cks = reinterpret_cast<float*>(vt + DH * (tp + PAD));   // CLS key
  float* cvs = cks + DH;                                         // CLS value
  float* cqs = cvs + DH;                                         // CLS query
  float* pl = cqs + DH;                                          // [tp] CLS-query weights
  float* red = pl + tp;                                          // [32]

  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long d = (long)heads * DH, d3 = 3 * d;
  const long hcol = (long)h * DH;
  const long rstride = (long)n_patches * d3;  // frame to frame
  // frame 0's q of this head; k and v sit d and 2d further
  const __nv_bfloat16* tube = qkv + ((long)b * t_frames * n_patches + n) * d3 + hcol;

  // stage k row-major and v transposed, 16 bytes a load
  constexpr int VEC = 8;
  for (int idx = tid; idx < tp * (DH / VEC); idx += nthr) {
    const int j = idx / (DH / VEC), c = (idx % (DH / VEC)) * VEC;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (j < t_frames) {
      const __nv_bfloat16* row = tube + j * rstride + c;
      kv = *reinterpret_cast<const uint4*>(row + d);
      vv = *reinterpret_cast<const uint4*>(row + 2 * d);
    }
    *reinterpret_cast<uint4*>(ks + j * (DH + PAD) + c) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) vt[(c + i) * (tp + PAD) + j] = ve[i];
  }
  const long cls_off = (long)b * d + hcol;
  for (int c = tid; c < DH; c += nthr) {
    cks[c] = to_f32(cls_k[cls_off + c]);
    cvs[c] = to_f32(cls_v[cls_off + c]);
    cqs[c] = to_f32(cls_q[cls_off + c]);
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group, column pair
  for (int qt = warp; qt * 16 < t_frames; qt += nwarps) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    const bool v0 = r0 < t_frames, v1 = r1 < t_frames;
    const __nv_bfloat16* q0 = tube + (v0 ? r0 : 0) * rstride;
    const __nv_bfloat16* q1 = tube + (v1 ? r1 : 0) * rstride;
    uint32_t qa[DH / 16][4];
    float lc0 = 0.f, lc1 = 0.f;  // the CLS key's logit, this thread's columns
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c = kk * 16 + tq * 2;
      qa[kk][0] = v0 ? ld_pair(q0 + c) : 0u;
      qa[kk][1] = v1 ? ld_pair(q1 + c) : 0u;
      qa[kk][2] = v0 ? ld_pair(q0 + c + 8) : 0u;
      qa[kk][3] = v1 ? ld_pair(q1 + c + 8) : 0u;
      lc0 += dot_pair(qa[kk][0], cks + c) + dot_pair(qa[kk][2], cks + c + 8);
      lc1 += dot_pair(qa[kk][1], cks + c) + dot_pair(qa[kk][3], cks + c + 8);
    }
    lc0 += __shfl_xor_sync(FULL, lc0, 1);
    lc0 += __shfl_xor_sync(FULL, lc0, 2);
    lc1 += __shfl_xor_sync(FULL, lc1, 1);
    lc1 += __shfl_xor_sync(FULL, lc1, 2);
    // the CLS key opens the running softmax: m = its logit, weight 1 (held
    // once a row, by column pair 0), output = cv
    float m0 = scale * lc0, m1 = scale * lc1;
    float l0 = tq == 0 ? 1.f : 0.f, l1 = l0;
    float o[DH / 8][4];
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int c = nt * 8 + tq * 2;
      o[nt][0] = o[nt][2] = cvs[c];
      o[nt][1] = o[nt][3] = cvs[c + 1];
    }

    for (int k0 = 0; k0 < tp; k0 += KC) {
      float s[KC / 8][4];
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        if (k0 + nt * 8 < tp) {  // warp-uniform
          const __nv_bfloat16* krow = ks + (k0 + nt * 8 + g) * (DH + PAD) + tq * 2;
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)
            mma_bf16(s[nt], qa[kk], ld_pair(krow + kk * 16), ld_pair(krow + kk * 16 + 8));
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + tq * 2 + (e & 1);
          const float v = key < t_frames ? scale * s[nt][e] : -CUDART_INF_F;
          s[nt][e] = v;
          if (e < 2) mx0 = fmaxf(mx0, v);
          else mx1 = fmaxf(mx1, v);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float cr0 = expf(m0 - mx0), cr1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
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
        s[nt][0] = expf(s[nt][0] - m0);
        s[nt][1] = expf(s[nt][1] - m0);
        s[nt][2] = expf(s[nt][2] - m1);
        s[nt][3] = expf(s[nt][3] - m1);
        l0 += s[nt][0] + s[nt][1];
        l1 += s[nt][2] + s[nt][3];
      }
      // P V, 16 keys a step: two logits tiles make one A fragment
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (k0 + kk * 16 < tp) {  // warp-uniform
          const uint32_t pa[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int nt = 0; nt < DH / 8; ++nt) {
            const __nv_bfloat16* vrow = vt + (nt * 8 + g) * (tp + PAD) + k0 + kk * 16 + tq * 2;
            mma_bf16(o[nt], pa, ld_pair(vrow), ld_pair(vrow + 8));
          }
        }
      }
    }

    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    __nv_bfloat16* o0 = out + (((long)b * t_frames + r0) * n_patches + n) * d + hcol;
    __nv_bfloat16* o1 = out + (((long)b * t_frames + r1) * n_patches + n) * d + hcol;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int c = nt * 8 + tq * 2;
      if (v0)
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
            __floats2bfloat162_rn(o[nt][0] / l0, o[nt][1] / l0);
      if (v1)
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
            __floats2bfloat162_rn(o[nt][2] / l1, o[nt][3] / l1);
    }
  }

  const long pidx = ((long)b * n_patches + n) * heads + h;
  cls_partials<DH>([&](int j, int c) { return to_f32(ks[j * (DH + PAD) + c]); },
                   [&](int j, int c) { return to_f32(vt[c * (tp + PAD) + j]); }, cqs, pl, red,
                   t_frames, scale, pidx, part_m, part_s, part_co);
}

template <int DH>
size_t f32_smem_bytes(int t_frames) {
  return 4 * (2 * (size_t)t_frames * DH + 3 * DH + t_frames + 32);
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
  cls_partials<DH>([&](int j, int c) { return ks[j * DH + c]; },
                   [&](int j, int c) { return vs[j * DH + c]; }, cqs, pl, red, t_frames, scale,
                   pidx, part_m, part_s, part_co);
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
  const dim3 grid(n_patches, heads, batch);
  cudaError_t err;
  if (is_bf16) {
    const size_t bytes = bf16_smem_bytes<DH>(t_frames);
    const int warps = pad16(t_frames) / 16 < WARPS ? pad16(t_frames) / 16 : WARPS;
    if ((err = allow_smem(headgrid_bf16_kernel<DH>, bytes)) != cudaSuccess) return (int)err;
    headgrid_bf16_kernel<DH><<<grid, warps * 32, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(cls_q),
        static_cast<const __nv_bfloat16*>(cls_k), static_cast<const __nv_bfloat16*>(cls_v),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_m),
        static_cast<float*>(part_s), static_cast<float*>(part_co), t_frames, n_patches, heads,
        scale);
  } else {
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
// is_bf16 selects bf16 (1) or f32 (0) for qkv, the CLS rows and out.
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
