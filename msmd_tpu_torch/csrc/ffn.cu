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
// Weights come in the nn.Linear layout: w1 (FFN, F), w2 (F, FFN); the
// products read them through the BT path of decoder_common.cuh's GEMM,
// with no transposed copies.
//
// Bound on an H100 SXM at the guided batch-48 shapes (rows 96 x 111 =
// 10656, F 512, FFN 2048): 44.7 GFLOP of bf16 products (45 us at 989
// TFLOP/s) against ~26 MB that must move (x in, out, weights; 8 us at
// 3.35 TB/s): bound by operations. This first version stages the hidden
// state (rows x FFN bf16, 44 MB at those shapes) and the f32 residual sum
// in a workspace, as K7 does; chaining the two products per row tile, so
// that h stays in shared memory, is queued for a later speed PR.

#include "decoder_common.cuh"

namespace {

struct FfnWs {
  bf16* h;   // (R, FFN) gelu(x W1 + b1), bf16
  float* y;  // (R, F) f32 residual sum
};

FfnWs carve_ffn(void* ws, int R, int F, int FF, size_t* total) {
  char* p = static_cast<char*>(ws);
  const size_t h_bytes = align256((size_t)R * FF * 2);
  *total = h_bytes + align256((size_t)R * F * 4);
  return FfnWs{p ? (bf16*)p : nullptr, p ? (float*)(p + h_bytes) : nullptr};
}

cudaError_t set_ffn_attributes() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  RETURN_IF_ERROR((gemm_attrs<EPI_GELU, true>()));
  RETURN_IF_ERROR((gemm_attrs<EPI_RESID_BF16, true>()));
  attr_set = true;
  return cudaSuccess;
}

}  // namespace

extern "C" size_t msmd_ffn_workspace_bytes(int R, int F, int FF) {
  size_t total = 0;
  carve_ffn(nullptr, R, F, FF, &total);
  return total;
}

// out (R, F) bf16 = LN(x + gelu_tanh(x w1^T + b1) w2^T + b2); x (R, F),
// w1 (FFN, F), b1 (FFN), w2 (F, FFN), b2 (F) bf16; g, b (F) f32. F and FFN
// multiples of 128, F <= 1024; any R. Launches on `stream`; returns the
// first CUDA error or 0.
extern "C" int msmd_ffn_forward(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                                const float* g, const float* b, bf16* out, void* ws, int R, int F, int FF,
                                cudaStream_t st) {
  if (R <= 0 || F % BN || FF % BN || F > 32 * LN_MAXN) return static_cast<int>(cudaErrorInvalidValue);
  RETURN_IF_ERROR(set_ffn_attributes());
  size_t total = 0;
  const FfnWs w = carve_ffn(ws, R, F, FF, &total);
  RETURN_IF_ERROR((gemm<EPI_GELU, true>(st, x, F, nullptr, w1, b1, nullptr, w.h, R, FF, F)));
  RETURN_IF_ERROR((gemm<EPI_RESID_BF16, true>(st, w.h, FF, nullptr, w2, b2, nullptr, w.y, R, F, FF, 1.0f, 0,
                                               nullptr, x)));
  ln_kernel<false, bf16><<<(R * 32 + LN_THREADS - 1) / LN_THREADS, LN_THREADS, 0, st>>>(
      w.y, nullptr, out, g, b, R, F, nullptr, nullptr, nullptr, nullptr, 1);
  return static_cast<int>(cudaGetLastError());
}
