// The merged softmax of Kimi-VL's latent attention at a decode step, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no generative path. It was
// added for the absorbed MLA decode of ops/latent_attention.py, where a
// query row's scores come from two products, the clip's shared prefix and
// the sequence's own tail: one softmax over both, with no concatenated
// copy, written straight in the bf16 the two weighted sums take.
//
// Per row r of `rows`: the P prefix scores sp[r, :] and the T tail scores
// st[r, :] (f32, contiguous), c = scale * log2(e):
//   m = max of both; z = sum of exp2((s - m) * c) over both (f32);
//   pp[r, j] = bf16(exp2((sp[r, j] - m) * c) / z), pt likewise.
// The plain version is ops/latent_attention.py::latent_softmax_ref.
//
// Bound: bytes. It reads 4 (P + T) and writes 2 (P + T) bytes a row; at the
// narrator's 10240 rows of 600 + 77 scores a layer, 41.6 MB, 12.4 us at
// 3.35 TB/s. Design: a warp a row, 8 warps a block; three passes over the
// row (max, sum, write), the second and third from L1/L2, where the first
// left it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kWarps * 32)
latent_softmax_kernel(const float* __restrict__ sp, const float* __restrict__ st, __nv_bfloat16* __restrict__ pp,
                      __nv_bfloat16* __restrict__ pt, int rows, int p, int t, float c) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* a = sp + static_cast<long long>(row) * p;
  const float* b = st + static_cast<long long>(row) * t;
  float m = -INFINITY;
  for (int j = lane; j < p; j += 32) m = fmaxf(m, a[j]);
  for (int j = lane; j < t; j += 32) m = fmaxf(m, b[j]);
  m = warp_max(m);
  const float mc = m * c;
  float z = 0.f;
  for (int j = lane; j < p; j += 32) z += exp2f(fmaf(a[j], c, -mc));
  for (int j = lane; j < t; j += 32) z += exp2f(fmaf(b[j], c, -mc));
  const float inv = 1.f / warp_sum(z);
  __nv_bfloat16* oa = pp + static_cast<long long>(row) * p;
  __nv_bfloat16* ob = pt + static_cast<long long>(row) * t;
  for (int j = lane; j < p; j += 32) oa[j] = __float2bfloat16(exp2f(fmaf(a[j], c, -mc)) * inv);
  for (int j = lane; j < t; j += 32) ob[j] = __float2bfloat16(exp2f(fmaf(b[j], c, -mc)) * inv);
}

}  // namespace

extern "C" int hh_latent_softmax(const void* sp, const void* st, void* pp, void* pt, int rows, int p, int t,
                                 float c, void* stream) {
  if (rows < 0 || p < 0 || t < 0 || p + t < 1 || !(c > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  latent_softmax_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sp), static_cast<const float*>(st), static_cast<__nv_bfloat16*>(pp),
      static_cast<__nv_bfloat16*>(pt), rows, p, t, c);
  return static_cast<int>(cudaGetLastError());
}
