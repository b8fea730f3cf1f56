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
// _tail_kernel: each product's left operand is bf16 (sa, V, the bf16 copy
// of x2, the hidden state), the sums are f32 and the biases are added in f32;
// x1 and x2 stay f32 between the stages; the residual x is f32(x); GELU is
// the erf form (_gelu without a dtype: erf even at bf16, unlike K6),
// through the Abramowitz & Stegun erf; out is bf16.
//
// Weights come in the nn.Linear layout: wso, wco (F, F), w1 (FFN, F), w2
// (F, FFN), read as they lie (K-major B operands).
//
// Bound on an H100 SXM at the guided batch-48 shapes (rows 96 x 110 =
// 10560, F 512, FFN 2048): 55.4 GFLOP (56 us at 989 TFLOP/s) against
// ~48 MB that must move (sa, x, V in, out, weights; 14 us at 3.35 TB/s):
// bound by operations. Four launches of the warp-specialized GEMM of
// gemm_ws.cuh: self-out and cross-out as two-CTA clusters whose epilogues
// take LN1 and LN2 (x1 f32, then x2 in place with its bf16 copy, in a
// workspace), FFN1 with the erf GELU into the bf16 hidden state, and FFN2
// with LN3 into out. Shapes that GEMM does not take run each product on
// decoder_common.cuh's wmma tile, the LayerNorms as ln_kernel passes over
// an f32 residual sum.

#include "decoder_common.cuh"
#include "gemm_ws.cuh"

namespace {

struct TailWs {
  float* x;   // (R, F) f32 x1, then x2
  bf16* xb;   // (R, F) bf16 copy of x2 (first of x1 on the wmma route)
  bf16* h;    // (R, FFN) bf16 gelu(x2 W1 + b1)
  float* y;   // (R, F) f32 residual sum of the wmma route, or null
};

TailWs carve_tail(void* ws, int R, int F, int FF, size_t* total) {
  const bool y = !(ws_ln_ok(R, F, F) && ws_ln_ok(R, F, FF));
  const size_t sizes[4] = {(size_t)R * F * 4, (size_t)R * F * 2, (size_t)R * FF * 2, y ? (size_t)R * F * 4 : 0};
  char* p = static_cast<char*>(ws);
  void* ptrs[4];
  size_t off = 0;
  for (int i = 0; i < 4; ++i) {
    ptrs[i] = p && sizes[i] ? p + off : nullptr;
    off += align256(sizes[i]);
  }
  *total = off;
  return TailWs{(float*)ptrs[0], (bf16*)ptrs[1], (bf16*)ptrs[2], (float*)ptrs[3]};
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
// any R. map_*: the weights' tensor maps (msmd_ws_weight_map), or null to
// make them here. Launches on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_tail_forward(const bf16* sa, const bf16* x, const bf16* vrows, const bf16* wso,
                                 const bf16* bso, const bf16* wco, const bf16* bco, const bf16* w1, const bf16* b1,
                                 const bf16* w2, const bf16* b2, const float* ln_scale, const float* ln_bias,
                                 bf16* out, void* ws, int R, int F, int FF, const void* map_wso,
                                 const void* map_wco, const void* map_w1, const void* map_w2, cudaStream_t st) {
  if (R <= 0 || F % BN || FF % BN || F > 32 * LN_MAXN) return static_cast<int>(cudaErrorInvalidValue);
  size_t total = 0;
  const TailWs w = carve_tail(ws, R, F, FF, &total);
  auto map = [](const void* m) { return static_cast<const CUtensorMap*>(m); };

  // x1 = LN1(x + sa Wso + bso); nothing reads x1's bf16 copy (the cross
  // product's left operand is V), which only the wmma route's LayerNorm
  // pass writes
  bf16* x1b = ws_ln_ok(R, F, F) ? nullptr : w.xb;
  RETURN_IF_ERROR(ws_product(st, 0, WS_LN, sa, map(map_wso), wso, bso, x, false, w.x, x1b, ln_scale, ln_bias, w.y,
                             R, F, F));
  // x2 = LN2(x1 + V Wco + bco), over x1's buffers
  RETURN_IF_ERROR(ws_product(st, 0, WS_LN, vrows, map(map_wco), wco, bco, w.x, true, w.x, w.xb, ln_scale + F,
                             ln_bias + F, w.y, R, F, F));
  // out = LN3(x2 + gelu_erf(x2 W1 + b1) W2 + b2)
  RETURN_IF_ERROR(ws_product(st, 0, WS_GELU_ERF, w.xb, map(map_w1), w1, b1, nullptr, false, nullptr, w.h, nullptr,
                             nullptr, nullptr, R, FF, F));
  return static_cast<int>(ws_product(st, 0, WS_LN, w.h, map(map_w2), w2, b2, w.x, true, nullptr, out,
                                     ln_scale + 2 * F, ln_bias + 2 * F, w.y, R, F, FF));
}
