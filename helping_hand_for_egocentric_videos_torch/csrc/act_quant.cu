// Fused activation -> per-row int8 quantization, for Hopper (sm_90a).
//
// Replaces: helping_hand_for_egocentric_videos_tpu/ops/act_quant.py,
//   K4 `layer_norm_int8` (`_ln_q_kernel` through `_rows_call`) and
//   K5 `quick_gelu_int8` (`_gelu_q_kernel` through `_rows_call`).
//
// What it computes, per row of a (rows, D) activation:
//   K4: y = LayerNorm(x) with f32 mean, centred variance and affine (eps
//       given; 1 / sqrtf, which rounds correctly, not the approximate rsqrtf);
//   K5: y = x * sigmoid(1.702 x) in f32;
// then the row's int8 codes and f32 scale by the rule in row_quant.cuh.
// The TPU pads the rows to 256-row tiles; here any row count runs and
// nothing is padded.
//
// Bound. Both are per-row passes that read each input once and write one
// byte a value: at the serving shape (32768 rows, bf16) K4 moves 101 MB
// (D = 1024) and K5 403 MB (D = 4096), 30 us and 120 us at 3.35 TB/s. The
// arithmetic (a few dozen flops a value) is far below the card's rate, so
// both are bound by bytes, and the float activation is never written back.
//
// K4 design: a warp a row, so that the three reductions of a row (mean,
// centred variance, abs-max) are warp shuffles, with no shared memory and no
// __syncthreads between them.
//   - The warp route, rows of whole 16-byte chunks up to 2048 values wide
//     that start on a 16-byte boundary (the model's are 1024 wide): lane l
//     holds the chunks l, l + 32, l + 64, ... of the row (8 bf16 or 4 f32
//     values each), so a warp's load instruction covers 512 neighbouring
//     bytes; at D = 1024 in bf16 a lane holds 32 values in four loads. At
//     most 64 values a lane stay in registers from the load to the store; the
//     variance is the second pass over them.
//   - gamma and beta (f32) are read from device memory once a block into
//     shared memory and from there as 16-byte loads.
//   - Blocks of 8 warps, as many as the card holds at once, walk the rows:
//     warp w takes rows w, w + W, ... (W warps in all) and has its next row's
//     loads in flight while it reduces and stores the current one.
//   - The codes leave 8 bytes a lane and chunk (4 for f32 chunks), the scale
//     from lane 0.
//   - The block route, every other row: wider than 2048 (up to MAX_WIDTH =
//     4096 of ops/act_quant.py: more than 64 values a lane would not stay in
//     registers), not a whole number of chunks, or off a 16-byte boundary.
//     These rows take row_quant.cuh's block-row kernel (256 threads a row,
//     a value at a time), K5's. The model never runs it.
//     hh_layer_norm_int8_plan names the route a row takes.
// K5 keeps row_quant.cuh's block-row kernel, as does K3's second pass.

#include <stdint.h>

#include "row_quant.cuh"

namespace {

constexpr int kLnWarps = 8;         // warps a block of K4's warp route
constexpr int kLnMaxWidth = 2048;   // widest row of the warp route: 64 values a lane
constexpr int kMaxDevices = 64;

enum LnRoute { kWarpRow = 0, kBlockRow = 1 };

// A bf16 pair (the lower index in the low half) as two floats.
__device__ __forceinline__ void bf16_pair(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

// A 16-byte chunk of T values as VEC = 16 / sizeof(T) floats.
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& c, float (&v)[VEC]) {
  if constexpr (sizeof(T) == 2) {
    bf16_pair(c.x, v[0], v[1]);
    bf16_pair(c.y, v[2], v[3]);
    bf16_pair(c.z, v[4], v[5]);
    bf16_pair(c.w, v[6], v[7]);
  } else {
    v[0] = __uint_as_float(c.x);
    v[1] = __uint_as_float(c.y);
    v[2] = __uint_as_float(c.z);
    v[3] = __uint_as_float(c.w);
  }
}

// The VEC codes of a chunk, 4 to a 32-bit word.
template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* p, const float (&v)[VEC], float inv) {
  uint32_t w[VEC / 4];
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k) {
    w[k] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[k] |= (uint32_t)(uint8_t)rowq::int8_code(v[4 * k + e], inv) << (8 * e);
  }
  if constexpr (VEC == 8) *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else *reinterpret_cast<uint32_t*>(p) = w[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K4's warp route: NC chunks of VEC = 16 / sizeof(T) values a lane, VEC
// dividing d.
template <typename T, int NC>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_int8_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ codes,
                    float* __restrict__ scales, long long rows, int d, float eps) {
  extern __shared__ __align__(16) float gb[];  // gamma [d], beta [d]
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    gb[i] = gamma[i];
    gb[d + i] = beta[i];
  }
  __syncthreads();
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int nchunks = d / VEC;
  const long long stride = (long long)gridDim.x * kLnWarps;
  long long row = (long long)blockIdx.x * kLnWarps + (threadIdx.x >> 5);

  uint4 cur[NC], nxt[NC];
  auto fetch = [&](long long r, uint4(&c)[NC]) {
    const T* xr = x + r * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int j = i * 32 + lane;
      if (j < nchunks) c[i] = *reinterpret_cast<const uint4*>(xr + j * VEC);
    }
  };
  if (row < rows) fetch(row, cur);
  for (; row < rows; row += stride) {
    if (row + stride < rows) fetch(row + stride, nxt);  // in flight under this row's work
    float v[NC][VEC];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i * 32 + lane < nchunks) {
        unpack<T, VEC>(cur[i], v[i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum += v[i][e];  // idle slots hold 0
    }
    const float mean = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i * 32 + lane < nchunks) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[i][e] -= mean;
          sq += v[i][e] * v[i][e];
        }
      }
    }
    const float rs = 1.f / sqrtf(warp_sum(sq) / d + eps);
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (i * 32 + lane < nchunks) {
        float g[VEC], b[VEC];
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(gb + c + k);
          const float4 b4 = *reinterpret_cast<const float4*>(gb + d + c + k);
          g[k] = g4.x, g[k + 1] = g4.y, g[k + 2] = g4.z, g[k + 3] = g4.w;
          b[k] = b4.x, b[k + 1] = b4.y, b[k + 2] = b4.z, b[k + 3] = b4.w;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[i][e] = v[i][e] * rs * g[e] + b[e];
          mx = fmaxf(mx, fabsf(v[i][e]));
        }
      }
    }
    const float s = fmaxf(warp_max(mx) / 127.f, 1e-8f);
    const float inv = 1.f / s;
    int8_t* qr = codes + row * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i * 32 + lane < nchunks) store_codes<VEC>(qr + (i * 32 + lane) * VEC, v[i], inv);
    }
    if (lane == 0) scales[row] = s;
#pragma unroll
    for (int i = 0; i < NC; ++i) cur[i] = nxt[i];
  }
}

// A launch of the warp route: as many blocks as the card holds at once, at
// most one warp a row. The occupancy of each instantiation is looked up once
// a device.
template <typename T, int NC>
int launch_ln_warp(const T* x, const float* g, const float* b, int8_t* q, float* s,
                   long long rows, int d, float eps, cudaStream_t st, long long* blocks_out) {
  static int sms[kMaxDevices], per_sm[kMaxDevices];
  const size_t smem = 2 * (size_t)d * sizeof(float);
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    int n = 0, k = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    // at the widest row, so one lookup serves every width
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &k, ln_int8_warp_kernel<T, NC>, kLnWarps * 32,
             2 * kLnMaxWidth * sizeof(float))) != cudaSuccess)
      return (int)err;
    if (k < 1) return (int)cudaErrorInvalidConfiguration;
    sms[dev] = n;
    per_sm[dev] = k;
  }
  const long long want = (rows + kLnWarps - 1) / kLnWarps, cap = (long long)per_sm[dev] * sms[dev];
  const long long blocks = want < cap ? want : cap;
  if (blocks_out) {
    *blocks_out = blocks;
    return 0;
  }
  ln_int8_warp_kernel<T, NC><<<(unsigned)blocks, kLnWarps * 32, smem, st>>>(x, g, b, q, s, rows,
                                                                          d, eps);
  return (int)cudaGetLastError();
}

// K4's route for rows of d values at x: a warp a row where d is a whole
// number of 16-byte chunks up to kLnMaxWidth and x starts on a 16-byte
// boundary, else a block a row.
template <typename T>
LnRoute ln_route(const T* x, int d) {
  constexpr int V = 16 / sizeof(T);
  return d <= kLnMaxWidth && d % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? kWarpRow
                                                                                       : kBlockRow;
}

// Launches K4 (or, with blocks_out, only reports the blocks it would take).
template <typename T>
int launch_ln(const T* x, const float* g, const float* b, int8_t* q, float* s, long long rows,
              int d, float eps, cudaStream_t st, long long* blocks_out = nullptr) {
  if (rows < 1 || rows > INT_MAX || d < 1 || d > rowq::kMaxVpt * rowq::kRowThreads)
    return (int)cudaErrorInvalidValue;
  const LnRoute route = ln_route(x, d);
  if (route == kBlockRow) {
    if (blocks_out) {
      *blocks_out = rows;
      return 0;
    }
    return rowq::launch_rows<rowq::RowOp::kLayerNorm>(x, g, b, q, s, rows, d, eps, st);
  }
  const int per_lane = (d / (16 / (int)sizeof(T)) + 31) / 32;  // chunks a lane
#define LN_WARP(NC) launch_ln_warp<T, NC>(x, g, b, q, s, rows, d, eps, st, blocks_out)
  if (per_lane <= 1) return LN_WARP(1);
  if (per_lane <= 2) return LN_WARP(2);
  if (per_lane <= 4) return LN_WARP(4);
  if constexpr (sizeof(T) == 2) {
    return LN_WARP(8);  // bf16: 8 chunks of 8 at 2048
  } else {
    if (per_lane <= 8) return LN_WARP(8);
    return LN_WARP(16);  // f32: 16 chunks of 4 at 2048
  }
#undef LN_WARP
}

template <rowq::RowOp OP>
int dispatch(const void* x, const void* gamma, const void* beta, void* codes, void* scales,
             long long rows, int d, float eps, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* q = static_cast<int8_t*>(codes);
  float* s = static_cast<float*>(scales);
  if constexpr (OP == rowq::RowOp::kLayerNorm) {
    if (is_bf16)
      return launch_ln(static_cast<const __nv_bfloat16*>(x), g, b, q, s, rows, d, eps, st);
    return launch_ln(static_cast<const float*>(x), g, b, q, s, rows, d, eps, st);
  }
  if (is_bf16)
    return rowq::launch_rows<OP>(static_cast<const __nv_bfloat16*>(x), g, b, q, s, rows, d,
                                 eps, st);
  return rowq::launch_rows<OP>(static_cast<const float*>(x), g, b, q, s, rows, d, eps, st);
}

}  // namespace

// K4. x (rows, d) f32 or bf16 (is_bf16), gamma and beta (d,) f32 ->
// codes (rows, d) int8, scales (rows,) f32. Returns 0 or the cudaError_t.
extern "C" int hh_layer_norm_int8(const void* x, const void* gamma, const void* beta,
                                  void* codes, void* scales, long long rows, int d, float eps,
                                  int is_bf16, void* stream) {
  return dispatch<rowq::RowOp::kLayerNorm>(x, gamma, beta, codes, scales, rows, d, eps,
                                           is_bf16, stream);
}

// K4's cut of rows x d values at x (reported by chip_smoke.py): plan =
// {route (0: a warp a row, 1: a block a row), values a lane (route 1: a
// thread), blocks, threads a block}. Returns 0 or a cudaError_t.
extern "C" int hh_layer_norm_int8_plan(const void* x, long long rows, int d, int is_bf16,
                                       long long* plan) {
  long long blocks = 0;
  const int rc = is_bf16 ? launch_ln(static_cast<const __nv_bfloat16*>(x), nullptr, nullptr,
                                     nullptr, nullptr, rows, d, 0.f, nullptr, &blocks)
                         : launch_ln(static_cast<const float*>(x), nullptr, nullptr, nullptr,
                                     nullptr, rows, d, 0.f, nullptr, &blocks);
  if (rc != 0) return rc;
  const LnRoute route = is_bf16 ? ln_route(static_cast<const __nv_bfloat16*>(x), d)
                                : ln_route(static_cast<const float*>(x), d);
  plan[0] = route;
  plan[1] = route == kBlockRow ? (d + rowq::kRowThreads - 1) / rowq::kRowThreads : (d + 31) / 32;
  plan[2] = blocks;
  plan[3] = route == kBlockRow ? rowq::kRowThreads : kLnWarps * 32;
  return 0;
}

// K5. x (rows, d) f32 or bf16 -> codes (rows, d) int8, scales (rows,) f32.
extern "C" int hh_quick_gelu_int8(const void* x, void* codes, void* scales, long long rows,
                                  int d, int is_bf16, void* stream) {
  return dispatch<rowq::RowOp::kQuickGelu>(x, nullptr, nullptr, codes, scales, rows, d, 0.f,
                                           is_bf16, stream);
}
