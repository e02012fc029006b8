// Per-row symmetric int8 quantization, fused with the op that produces the
// row, for Hopper (sm_90a). Included by act_quant.cu (K5, and K4's rows
// wider than its warp route takes) and divided_attention.cu (K3's second
// pass).
//
// The rounding rule is the JAX package's `_quantize_rows`, `int8_linear`
// and `quant_out` rule, bit for bit on the same f32 row:
//   s = max(max|y| / 127, 1e-8)           (a division by 127)
//   q = clip(round_half_even(y * (1 / s)), -127, 127)
// so `rintf` (round half to even), never `roundf` (halves away from zero).
//
// Design. One block of kRowThreads threads per row. Element c of the row
// lives in thread c % kRowThreads, slot c / kRowThreads, so every load and
// store of a warp touches neighbouring addresses. The row stays in registers
// (VPT floats a thread, up to D = 16 * kRowThreads = 4096) from the load to
// the int8 store: device memory sees each input byte once and each code
// once. Sums and the abs-max are f32 block reductions (warp shuffles, then
// one shared-memory step).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace rowq {

constexpr int kRowThreads = 256;
constexpr int kMaxVpt = 16;  // widest row: kMaxVpt * kRowThreads = 4096

enum class RowOp { kIdentity, kLayerNorm, kQuickGelu };

__device__ __forceinline__ float load_f32(float x) { return x; }
__device__ __forceinline__ float load_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The code of y at inverse scale inv: clip(round_half_even(y * inv), +-127).
__device__ __forceinline__ int8_t int8_code(float y, float inv) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y * inv), -127.f), 127.f));
}

// Sum (is_max false) or max of v over the block; every thread gets the result.
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red may still be read by an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kRowThreads / 32; ++i) v = is_max ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

// y -> OP(y) -> int8 codes of the row and its f32 scale.
template <RowOp OP, typename T, int VPT>
__global__ void __launch_bounds__(kRowThreads)
row_int8_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, int8_t* __restrict__ codes,
                float* __restrict__ scales, int d, float eps) {
  __shared__ float red[kRowThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const int tid = threadIdx.x;

  float v[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = i * kRowThreads + tid;
    v[i] = c < d ? load_f32(xr[c]) : 0.f;
  }

  if constexpr (OP == RowOp::kLayerNorm) {
    // f32 statistics and affine, as layers.layer_norm
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) sum += v[i];  // idle slots hold 0
    const float mean = block_reduce(sum, false, red) / d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (i * kRowThreads + tid < d) {
        v[i] -= mean;
        sq += v[i] * v[i];
      }
    }
    // 1 / sqrtf rounds correctly; rsqrtf is approximate
    const float rs = 1.f / sqrtf(block_reduce(sq, false, red) / d + eps);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = i * kRowThreads + tid;
      if (c < d) v[i] = v[i] * rs * gamma[c] + beta[c];
    }
  } else if constexpr (OP == RowOp::kQuickGelu) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) v[i] = v[i] * (1.f / (1.f + expf(-1.702f * v[i])));
  }

  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (i * kRowThreads + tid < d) mx = fmaxf(mx, fabsf(v[i]));
  }
  const float s = fmaxf(block_reduce(mx, true, red) / 127.f, 1e-8f);
  const float inv = 1.f / s;
  int8_t* qr = codes + row * d;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = i * kRowThreads + tid;
    if (c < d) qr[c] = int8_code(v[i], inv);
  }
  if (tid == 0) scales[row] = s;
}

// Launch one block per row; returns 0 or a cudaError_t.
template <RowOp OP, typename T>
int launch_rows(const T* x, const float* gamma, const float* beta, int8_t* codes,
                float* scales, long long rows, int d, float eps, cudaStream_t stream) {
  if (rows < 1 || rows > INT_MAX || d < 1 || d > kMaxVpt * kRowThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows);
#define ROWQ_LAUNCH(VPT)                                                                 \
  row_int8_kernel<OP, T, VPT><<<grid, kRowThreads, 0, stream>>>(x, gamma, beta, codes, \
                                                                 scales, d, eps)
  if (d <= kRowThreads) ROWQ_LAUNCH(1);
  else if (d <= 2 * kRowThreads) ROWQ_LAUNCH(2);
  else if (d <= 4 * kRowThreads) ROWQ_LAUNCH(4);
  else if (d <= 8 * kRowThreads) ROWQ_LAUNCH(8);
  else ROWQ_LAUNCH(16);
#undef ROWQ_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace rowq
