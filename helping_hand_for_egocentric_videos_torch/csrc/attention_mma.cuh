// Warp-level building blocks of the bf16 attention kernels for Hopper
// (sm_90a): tensor-core products (mma.sync m16n8k16, bf16 in, f32 sums),
// fragment loads from shared memory (ldmatrix) and 16-byte asynchronous
// copies from device memory (cp.async). Included by divided_attention.cu
// (K1, K2, K3), divided_attention_long.cu (K6) and decode_attention.cu (K8).
//
// Fragment layout of m16n8k16 (g = lane / 4, tq = lane % 4):
//   A (16x16, row-major): a0 = (row g, cols 2tq, 2tq+1), a1 = (row g+8, the
//     same cols), a2 = (row g, cols 2tq+8, 2tq+9), a3 = (row g+8, those);
//   B (16x8, col-major): b0 = (rows 2tq, 2tq+1, col g), b1 = (rows 2tq+8,
//     2tq+9, col g);
//   C (16x8, f32): c0, c1 = (row g, cols 2tq, 2tq+1), c2, c3 = (row g+8).
// The lower index of each pair sits in the low 16 bits of its register.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) rounded to a bf16 pair h, and the bf16 pair r of what the rounding
// left out: h + r holds about 16 bits of each.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& h, uint32_t& r) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hv);
  const __nv_bfloat162 rv = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  h = *reinterpret_cast<const uint32_t*>(&hv);
  r = *reinterpret_cast<const uint32_t*>(&rv);
}

__device__ __forceinline__ float dot_pair(uint32_t u, const float* w) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return f.x * w[0] + f.y * w[1];
}

// c += a (16x16, row) . b (16x8, col); bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lane i gives the address of row
// i % 8 of matrix i / 8 (16 bytes, 16-byte aligned); r[m] is matrix m's
// fragment, (row g, cols 2tq, 2tq+1), or with `trans` (rows 2tq, 2tq+1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes from device to shared memory, asynchronously; `valid` false
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are pending (n > 7
// waits for all but 7).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Max (is_max) or sum of v over the block; blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = is_max ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

}  // namespace attn
