// Fused activation -> per-row int8 quantization, for Hopper (sm_90a).
//
// Replaces: helping_hand_for_egocentric_videos_tpu/ops/act_quant.py,
//   K4 `layer_norm_int8` (`_ln_q_kernel` through `_rows_call`) and
//   K5 `quick_gelu_int8` (`_gelu_q_kernel` through `_rows_call`).
//
// What it computes, per row of a (rows, D) activation:
//   K4: y = LayerNorm(x) with f32 mean, variance and affine (eps given);
//   K5: y = x * sigmoid(1.702 x) in f32;
// then the row's int8 codes and f32 scale by the rule in row_quant.cuh.
// The TPU pads the rows to 256-row tiles; here a block owns one row, so any
// row count runs and nothing is padded.
//
// Bound. Both are per-row passes that read each input once and write one
// byte a value: at the serving shape (32768 rows, bf16) K4 moves 101 MB
// (D = 1024) and K5 403 MB (D = 4096), 30 us and 120 us at 3.35 TB/s. The
// arithmetic (a few dozen flops a value) is far below the card's rate, so
// both are bound by bytes; the design keeps the row in registers between
// the load and the store and so never writes the float activation back.

#include "row_quant.cuh"

namespace {

template <rowq::RowOp OP>
int dispatch(const void* x, const void* gamma, const void* beta, void* codes, void* scales,
             long long rows, int d, float eps, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* q = static_cast<int8_t*>(codes);
  float* s = static_cast<float*>(scales);
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

// K5. x (rows, d) f32 or bf16 -> codes (rows, d) int8, scales (rows,) f32.
extern "C" int hh_quick_gelu_int8(const void* x, void* codes, void* scales, long long rows,
                                  int d, int is_bf16, void* stream) {
  return dispatch<rowq::RowOp::kQuickGelu>(x, nullptr, nullptr, codes, scales, rows, d, 0.f,
                                           is_bf16, stream);
}
