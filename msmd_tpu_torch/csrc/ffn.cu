// K6: the inference FFN block of a post-LN decoder layer, hand-written for
// Hopper (sm_90a) and bound to PyTorch through a plain C interface:
//
//   out = LN(x + gelu(x W1 + b1) W2 + b2)
//
// Replaces msmd_tpu/ops/pallas/ffn_kernel.py::fused_ffn_ln (_ffn_kernel),
// which the bf16 XLA-decoder route of the JAX sampler runs in every layer
// of every step (guided sampling always takes that route). Rounding
// follows _ffn_kernel: x is bf16 and is the first product's left operand;
// the sums are f32 and the biases are added in f32; GELU is the tanh form
// (decoder_kernel.py::_gelu picks it for bf16 weights) and its output is
// cast to bf16 as the second product's left operand; the residual is
// f32(x) + y; LayerNorm is f32; out is bf16.
//
// Weights come in the nn.Linear layout: w1 (FFN, F), w2 (F, FFN), read as
// they lie (K-major B operands); no transposed copy is made.
//
// Bound on an H100 SXM at the guided batch-48 shapes (rows 96 x 111 =
// 10656, F 512, FFN 2048): 44.7 GFLOP of bf16 products (45 us at 989
// TFLOP/s) against ~26 MB that must move (x in, out, weights; 8 us at
// 3.35 TB/s): bound by operations. Two launches of the warp-specialized
// GEMM of gemm_ws.cuh: FFN1 with the GELU epilogue into the bf16 hidden
// state h (rows x FFN, 44 MB, in a workspace), then FFN2 as two-CTA
// clusters whose epilogue adds the residual and takes the LayerNorm. Shapes
// that GEMM does not take (fewer than 1024 rows, other widths) run each
// product on decoder_common.cuh's wmma tile, FFN2 with an ln_kernel pass
// over an f32 residual sum.

#include "decoder_common.cuh"
#include "gemm_ws.cuh"

namespace {

struct FfnWs {
  bf16* h;   // (R, FFN) gelu(x W1 + b1), bf16
  float* y;  // (R, F) f32 residual sum of the wmma route, or null
};

FfnWs carve_ffn(void* ws, int R, int F, int FF, size_t* total) {
  char* p = static_cast<char*>(ws);
  const size_t h_bytes = align256((size_t)R * FF * 2);
  const bool y = !ws_ln_ok(R, F, FF);
  *total = h_bytes + (y ? align256((size_t)R * F * 4) : 0);
  return FfnWs{p ? (bf16*)p : nullptr, p && y ? (float*)(p + h_bytes) : nullptr};
}

}  // namespace

extern "C" size_t msmd_ffn_workspace_bytes(int R, int F, int FF) {
  size_t total = 0;
  carve_ffn(nullptr, R, F, FF, &total);
  return total;
}

// out (R, F) bf16 = LN(x + gelu_tanh(x w1^T + b1) w2^T + b2); x (R, F),
// w1 (FFN, F), b1 (FFN), w2 (F, FFN), b2 (F) bf16; g, b (F) f32. F and FFN
// multiples of 128, F <= 1024; any R. map_w1, map_w2: the weights' tensor
// maps (msmd_ws_weight_map), or null to make them here. Launches on
// `stream`; returns the first CUDA error or 0.
extern "C" int msmd_ffn_forward(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                                const float* g, const float* b, bf16* out, void* ws, int R, int F, int FF,
                                const void* map_w1, const void* map_w2, cudaStream_t st) {
  if (R <= 0 || F % BN || FF % BN || F > 32 * LN_MAXN) return static_cast<int>(cudaErrorInvalidValue);
  size_t total = 0;
  const FfnWs w = carve_ffn(ws, R, F, FF, &total);
  const CUtensorMap *m1 = static_cast<const CUtensorMap*>(map_w1), *m2 = static_cast<const CUtensorMap*>(map_w2);
  RETURN_IF_ERROR(ws_product(st, 0, WS_GELU, x, m1, w1, b1, nullptr, false, nullptr, w.h, nullptr, nullptr, nullptr,
                             R, FF, F));
  return static_cast<int>(ws_product(st, 0, WS_LN, w.h, m2, w2, b2, x, false, nullptr, out, g, b, w.y, R, F, FF));
}
