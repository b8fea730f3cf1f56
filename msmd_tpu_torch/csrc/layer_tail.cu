// K9: the motion-row tail of a post-LN decoder layer under the width-1
// alignment band, hand-written for Hopper (sm_90a) and bound to PyTorch
// through a plain C interface:
//
//   x1  = LN1(x + sa Wso + bso)
//   x2  = LN2(x1 + V Wco + bco)
//   out = LN3(x2 + gelu(x2 W1 + b1) W2 + b2)
//
// Replaces msmd_tpu/ops/pallas/layer_tail_kernel.py::fused_layer_tail
// (_tail_kernel), the opt-in (MSMD_FUSED_TAIL=1) layer tail of the
// XLA-decoder route; the person rows stay outside, in plain ops. Motion
// row e * lm + i takes memory-V row e * lm + i (the one-hot softmax of the
// band), so the rows have no entry structure. Rounding follows
// _tail_kernel: each product's left operand is bf16 (sa, V, then bf16
// copies of x1 and x2), the sums are f32 and the biases are added in f32;
// x1 and x2 stay f32 between the stages; the residual x is f32(x); GELU is
// the erf form (_gelu without a dtype: erf even at bf16, unlike K6),
// through the Abramowitz & Stegun erf; out is bf16.
//
// Weights come in the nn.Linear layout: wso, wco (F, F), w1 (FFN, F), w2
// (F, FFN); the four products read them through the BT path of
// decoder_common.cuh's GEMM.
//
// Bound on an H100 SXM at the guided batch-48 shapes (rows 96 x 110 =
// 10560, F 512, FFN 2048): 55.4 GFLOP (56 us at 989 TFLOP/s) against
// ~48 MB that must move (sa, x, V in, out, weights; 14 us at 3.35 TB/s):
// bound by operations. This first version runs the four products and
// three LayerNorms as seven launches with x1/x2, their bf16 copies, the
// hidden state and the residual sums in a workspace.

#include "decoder_common.cuh"

namespace {

struct TailWs {
  float* y;   // (R, F) f32 residual sum
  float* x;   // (R, F) f32 x1, then x2
  bf16* xb;   // (R, F) bf16 copy of x1, then of x2
  bf16* h;    // (R, FFN) bf16 gelu(x2 W1 + b1)
};

TailWs carve_tail(void* ws, int R, int F, int FF, size_t* total) {
  const size_t sizes[4] = {(size_t)R * F * 4, (size_t)R * F * 4, (size_t)R * F * 2, (size_t)R * FF * 2};
  char* p = static_cast<char*>(ws);
  void* ptrs[4];
  size_t off = 0;
  for (int i = 0; i < 4; ++i) {
    ptrs[i] = p ? p + off : nullptr;
    off += align256(sizes[i]);
  }
  *total = off;
  return TailWs{(float*)ptrs[0], (float*)ptrs[1], (bf16*)ptrs[2], (bf16*)ptrs[3]};
}

cudaError_t set_tail_attributes() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  RETURN_IF_ERROR((gemm_attrs<EPI_RESID_BF16, true>()));
  RETURN_IF_ERROR((gemm_attrs<EPI_RESID, true>()));
  RETURN_IF_ERROR((gemm_attrs<EPI_GELU_ERF, true>()));
  attr_set = true;
  return cudaSuccess;
}

}  // namespace

extern "C" size_t msmd_tail_workspace_bytes(int R, int F, int FF) {
  size_t total = 0;
  carve_tail(nullptr, R, F, FF, &total);
  return total;
}

// out (R, F) bf16, the motion-row tail above; sa, x, vrows (R, F) bf16;
// wso, wco (F, F), w1 (FFN, F), w2 (F, FFN) and the biases bf16; ln_scale,
// ln_bias (3, F) f32 (LN1, LN2, LN3). F and FFN multiples of 128, F <= 1024;
// any R. Launches on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_tail_forward(const bf16* sa, const bf16* x, const bf16* vrows, const bf16* wso,
                                 const bf16* bso, const bf16* wco, const bf16* bco, const bf16* w1, const bf16* b1,
                                 const bf16* w2, const bf16* b2, const float* ln_scale, const float* ln_bias,
                                 bf16* out, void* ws, int R, int F, int FF, cudaStream_t st) {
  if (R <= 0 || F % BN || FF % BN || F > 32 * LN_MAXN) return static_cast<int>(cudaErrorInvalidValue);
  RETURN_IF_ERROR(set_tail_attributes());
  size_t total = 0;
  const TailWs w = carve_tail(ws, R, F, FF, &total);
  const int ln_blocks = (R * 32 + LN_THREADS - 1) / LN_THREADS;

  // x1 = LN1(x + sa Wso + bso)
  RETURN_IF_ERROR((gemm<EPI_RESID_BF16, true>(st, sa, F, nullptr, wso, bso, nullptr, w.y, R, F, F, 1.0f, 0,
                                               nullptr, x)));
  ln_kernel<false, bf16><<<ln_blocks, LN_THREADS, 0, st>>>(w.y, w.x, w.xb, ln_scale, ln_bias, R, F, nullptr,
                                                           nullptr, nullptr, nullptr, 1);
  RETURN_IF_ERROR(cudaGetLastError());
  // x2 = LN2(x1 + V Wco + bco), over x1's buffers
  RETURN_IF_ERROR((gemm<EPI_RESID, true>(st, vrows, F, nullptr, wco, bco, w.x, w.y, R, F, F)));
  ln_kernel<false, bf16><<<ln_blocks, LN_THREADS, 0, st>>>(w.y, w.x, w.xb, ln_scale + F, ln_bias + F, R, F,
                                                           nullptr, nullptr, nullptr, nullptr, 1);
  RETURN_IF_ERROR(cudaGetLastError());
  // out = LN3(x2 + gelu_erf(x2 W1 + b1) W2 + b2)
  RETURN_IF_ERROR((gemm<EPI_GELU_ERF, true>(st, w.xb, F, nullptr, w1, b1, nullptr, w.h, R, FF, F)));
  RETURN_IF_ERROR((gemm<EPI_RESID, true>(st, w.h, FF, nullptr, w2, b2, w.x, w.y, R, F, FF)));
  ln_kernel<false, bf16><<<ln_blocks, LN_THREADS, 0, st>>>(w.y, nullptr, out, ln_scale + 2 * F, ln_bias + 2 * F,
                                                           R, F, nullptr, nullptr, nullptr, nullptr, 1);
  return static_cast<int>(cudaGetLastError());
}
