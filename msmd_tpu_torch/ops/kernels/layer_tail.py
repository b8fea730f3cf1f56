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
"""

from __future__ import annotations

import ctypes

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _layernorm
from msmd_tpu_torch.ops.kernels.ffn_train import gelu_erf


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
        lib.msmd_tail_forward.argtypes = [vp] * 15 + [ci] * 3 + [vp]
        lib.msmd_tail_forward.restype = ci
        lib._msmd_typed = True
    return lib


def fused_layer_tail(sa_m, x_m, v_rows, wso, bso, wco, bco, w1, b1, w2, b2, ln_scale, ln_bias) -> torch.Tensor:
    """The motion-row layer tail; sa_m (the self-attention output before its
    out-projection) and x_m (the layer input) (Be, lm, F), v_rows (Be*lm, F)
    -> (Be, lm, F). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16 activations and weights, f32 LayerNorm
    parameters, F and FFN multiples of 128, F <= 1024) or raises."""
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
    R = Be * lm
    lib = _lib()
    out = torch.empty_like(x_m)
    ws = torch.empty(lib.msmd_tail_workspace_bytes(R, F, FF), dtype=torch.uint8, device=x_m.device)
    tensors = (sa_m, x_m, v_rows, wso, bso, wco, bco, w1, b1, w2, b2, ln_scale, ln_bias, out, ws)
    rc = lib.msmd_tail_forward(*(_build.ptr(t) for t in tensors), R, F, FF, _build.stream(x_m.device))
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
