"""K9, the motion-row tail of a decoder layer under the width-1 alignment
band: a hand-written CUDA kernel (``csrc/layer_tail.cu``) and its plain
PyTorch version.

Replaces ``msmd_tpu/ops/pallas/layer_tail_kernel.py::fused_layer_tail``:

    x1  = LN1(x + sa Wso + bso)
    x2  = LN2(x1 + V Wco + bco)
    out = LN3(x2 + gelu(x2 W1 + b1) W2 + b2)

for the motion rows of every entry (motion row e*lm + i gathers memory-V
row e*lm + i, the one-hot softmax of the band); the person rows stay
outside. Both versions round where ``_tail_kernel`` rounds: every
product's left operand is cast to the weights' dtype and summed in f32,
the biases are added in f32, x1 and x2 stay f32 between the stages, and
the output takes x's dtype. GELU is the erf form (Abramowitz & Stegun) at
every dtype: ``_tail_kernel`` calls ``_gelu`` without a dtype, unlike K6.

Weights are in the ``nn.Linear`` layout (wso, wco (F, F), w1 (FFN, F),
w2 (F, FFN)); the JAX kernel takes their transposes. LayerNorm
parameters are stacked (3, F) f32: LN1, LN2, LN3. The kernel takes bf16
and any row count; the JAX sampler keeps the K6 route when
``tail_rows_tile`` finds no row tile of at most 2048 (a TPU VMEM limit,
``msmd_tpu/models/diffusion.py``:648).

The kernel is four products (``tail_products``): self-out and cross-out
with LN1 and LN2 in their epilogues, FFN1 with the erf GELU, FFN2 with LN3,
each on the warp-specialized GEMM of ``csrc/gemm_ws.cuh`` where that takes
its shape (``ops/kernels/gemm_ws.py``), else on the wmma tile with a
LayerNorm pass. ``prepare_tail_weights`` makes the kernel's weights (bf16
copies, the stacked LayerNorm tables, the weights' tensor maps) once, for
the many calls of a sampling window.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _layernorm
from msmd_tpu_torch.ops.kernels.ffn_train import gelu_erf
from msmd_tpu_torch.ops.kernels.gemm_ws import WeightMaps, gemm_ws_plan, gemm_ws_work


def layer_tail_plain(sa_m, x_m, v_rows, wso, bso, wco, bco, w1, b1, w2, b2, ln_scale, ln_bias) -> torch.Tensor:
    """K9 in plain PyTorch. sa_m, x_m (Be, lm, F) and v_rows (Be*lm, F) ->
    (Be, lm, F) in x_m's dtype."""
    Be, lm, F = x_m.shape
    cdt = wso.dtype
    dot = lambda a, w: a.to(cdt).float() @ w.float().t()
    s, bb = ln_scale.float(), ln_bias.float()
    so = dot(sa_m.reshape(-1, F), wso) + bso.float()
    x1 = _layernorm(x_m.reshape(-1, F).float() + so, s[0], bb[0])
    x2 = _layernorm(x1 + dot(v_rows, wco) + bco.float(), s[1], bb[1])
    h = gelu_erf(dot(x2, w1) + b1.float())
    out = _layernorm(x2 + dot(h, w2) + b2.float(), s[2], bb[2])
    return out.to(x_m.dtype).reshape(Be, lm, F)


def _lib():
    lib = _build.load("layer_tail")
    if not getattr(lib, "_msmd_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmd_tail_workspace_bytes.argtypes = [ci] * 3
        lib.msmd_tail_workspace_bytes.restype = ctypes.c_size_t
        lib.msmd_tail_forward.argtypes = [vp] * 15 + [ci] * 3 + [vp] * 5
        lib.msmd_tail_forward.restype = ci
        lib._msmd_typed = True
    return lib


def fused_layer_tail(sa_m, x_m, v_rows, wso, bso, wco, bco, w1, b1, w2, b2, ln_scale, ln_bias,
                     maps: Optional[WeightMaps] = None) -> torch.Tensor:
    """The motion-row layer tail; sa_m (the self-attention output before its
    out-projection) and x_m (the layer input) (Be, lm, F), v_rows (Be*lm, F)
    -> (Be, lm, F). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16 activations and weights, f32 LayerNorm
    parameters, F and FFN multiples of 128, F <= 1024) or raises. ``maps``:
    the weights' tensor maps (``prepare_tail_weights``), or None to make
    them in the call."""
    if _build.on_cpu("fused_layer_tail", x_m):
        return layer_tail_plain(sa_m, x_m, v_rows, wso, bso, wco, bco, w1, b1, w2, b2, ln_scale, ln_bias)
    Be, lm, F = x_m.shape
    FF = w1.shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    _build.check_args("fused_layer_tail", x_m.device, sa_m=(sa_m, (Be, lm, F), bf), x_m=(x_m, (Be, lm, F), bf),
                      v_rows=(v_rows, (Be * lm, F), bf), wso=(wso, (F, F), bf), bso=(bso, (F,), bf),
                      wco=(wco, (F, F), bf), bco=(bco, (F,), bf), w1=(w1, (FF, F), bf), b1=(b1, (FF,), bf),
                      w2=(w2, (F, FF), bf), b2=(b2, (F,), bf), ln_scale=(ln_scale, (3, F), f32),
                      ln_bias=(ln_bias, (3, F), f32))
    if F % 128 or FF % 128 or F > 1024:
        raise ValueError(f"fused_layer_tail: the kernel needs F and FFN multiples of 128 and F <= 1024 "
                         f"(F={F}, FFN={FF})")
    map_args = maps.for_weights(wso, wco, w1, w2) if maps is not None else (None,) * 4
    R = Be * lm
    lib = _lib()
    out = torch.empty_like(x_m)
    ws = torch.empty(lib.msmd_tail_workspace_bytes(R, F, FF), dtype=torch.uint8, device=x_m.device)
    tensors = (sa_m, x_m, v_rows, wso, bso, wco, bco, w1, b1, w2, b2, ln_scale, ln_bias, out, ws)
    rc = lib.msmd_tail_forward(*(_build.ptr(t) for t in tensors), R, F, FF, *map_args, _build.stream(x_m.device))
    _build.check(lib, rc, "fused_layer_tail")
    fused_layer_tail.launches += 1
    return out


fused_layer_tail.launches = 0


def tail_work(rows: int, F: int, FF: int):
    """(flops, bytes) of one call at bf16 weights and f32 LayerNorm
    parameters: two (rows, F) x (F, F) products and two FFN products; sa,
    x and the V rows read once, out written once, every parameter read
    once."""
    flops = 2 * rows * F * (2 * F + 2 * FF)
    nbytes = 4 * rows * F * 2 + (2 * F * F + 2 * F * FF) * 2 + (3 * F + FF) * 2 + 6 * F * 4
    return flops, nbytes


def tail_products(rows: int, F: int, FF: int) -> dict:
    """K9's four products at ``rows`` motion rows, in the order the kernel
    runs them: (M, N, K), the epilogue and its residual (bf16 x, then the
    f32 x1 and x2) and output (f32 x1; f32 x2 with its bf16 copy, FFN1's
    left operand; then bf16 out)
    in ``gemm_ws``'s terms, the launch plan (``gemm_ws_plan``) and the work
    (``gemm_ws_work``: the products' operations sum to ``tail_work``'s;
    their bytes also count x1, x2 and h, written and read again)."""
    shapes = {"self_out": (rows, F, F, "resid_ln", 2, "x"), "cross_out": (rows, F, F, "resid_ln", 4, "x_xb"),
              "ffn1": (rows, FF, F, "gelu_erf", None, "bf16"), "ffn2": (rows, F, FF, "resid_ln", 4, "bf16")}
    out = {}
    for name, (M, N, K, epi, res_bytes, o) in shapes.items():
        flops, nbytes = gemm_ws_work(M, N, K, epi, res_bytes or 0, o)
        out[name] = {"M": M, "N": N, "K": K, "epilogue": epi, "res": {None: None, 2: "bf16", 4: "f32"}[res_bytes],
                     "out": o, "plan": gemm_ws_plan(M, N, K, epi), "flops": flops, "bytes": nbytes}
    return out


class TailWeights(NamedTuple):
    """K9's weights as the kernel takes them: ``fused_layer_tail(sa_m, x_m,
    v_rows, *weights)``."""
    wso: torch.Tensor
    bso: torch.Tensor
    wco: torch.Tensor
    bco: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    maps: Optional[WeightMaps]


def prepare_tail_weights(wso, bso, wco, bco, w1, b1, w2, b2, ln_scales, ln_biases, dtype) -> TailWeights:
    """K9's weights made once: ``dtype`` copies of the weights and biases
    (the nn.Linear layout; no copy where they are ``dtype`` already), the
    three LayerNorms' parameters (``ln_scales``, ``ln_biases``: LN1, LN2,
    LN3) stacked into (3, F) f32 tables and, for bf16 weights on the card,
    the weights' tensor maps. Detached: the kernel runs in eval mode only."""
    ws = [t.detach().to(dtype).contiguous() for t in (wso, bso, wco, bco, w1, b1, w2, b2)]
    ln_scale = torch.stack([t.detach() for t in ln_scales]).float()
    ln_bias = torch.stack([t.detach() for t in ln_biases]).float()
    maps = None
    if ws[0].device.type == "cuda" and dtype == torch.bfloat16:
        F, FF = ws[0].shape[0], ws[4].shape[0]
        maps = WeightMaps((ws[0], ws[2], ws[4], ws[6]),
                          ((F, F, "resid_ln"), (F, F, "resid_ln"), (FF, F, "gelu_erf"), (F, FF, "resid_ln")))
    return TailWeights(*ws, ln_scale, ln_bias, maps)
