"""K6, the inference FFN block of a decoder layer: a hand-written CUDA
kernel (``csrc/ffn.cu``) and its plain PyTorch version.

Replaces ``msmd_tpu/ops/pallas/ffn_kernel.py::fused_ffn_ln``:

    out = LN(x + gelu(x W1 + b1) W2 + b2)

which the bf16 XLA-decoder route of the sampler runs in every layer of
every step. Both versions round where ``_ffn_kernel`` rounds: x and the
hidden state are cast to the weights' dtype before each product, the sums
and the biases are f32, the residual is ``f32(x) + y``, LayerNorm is f32,
and the output takes x's dtype. GELU follows the weights' dtype as
``decoder_kernel.py::_gelu`` does: the tanh form for bf16 weights, the
erf form (Abramowitz & Stegun) for f32; the plain ``FeedForward`` module
is erf at every dtype, and the two differ by up to 3e-4.

Weights are in the ``nn.Linear`` layout (w1 (FFN, F), w2 (F, FFN)); the
JAX kernel takes their transposes. The kernel takes bf16 and any row
count; the JAX layer keeps its flax ops when no row tile of at most 2048
divides the rows (a TPU VMEM limit, ``msmd_tpu/models/transformer.py``:274).
"""

from __future__ import annotations

import ctypes

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _layernorm, gelu_tanh
from msmd_tpu_torch.ops.kernels.ffn_train import gelu_erf


def ffn_ln_plain(x, w1, b1, w2, b2, g, b) -> torch.Tensor:
    """K6 in plain PyTorch. x (..., F) -> (..., F) in x's dtype."""
    cdt = w1.dtype
    rnd = lambda a: a.to(cdt).float()
    F = x.shape[-1]
    x2 = x.reshape(-1, F)
    u = rnd(x2) @ w1.float().t() + b1.float()
    h = gelu_tanh(u) if cdt == torch.bfloat16 else gelu_erf(u)
    y = rnd(h) @ w2.float().t() + b2.float()
    out = _layernorm(x2.float() + y, g.float(), b.float())
    return out.to(x.dtype).reshape(x.shape)


def _lib():
    lib = _build.load("ffn")
    if not getattr(lib, "_msmd_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmd_ffn_workspace_bytes.argtypes = [ci] * 3
        lib.msmd_ffn_workspace_bytes.restype = ctypes.c_size_t
        lib.msmd_ffn_forward.argtypes = [vp] * 9 + [ci] * 3 + [vp]
        lib.msmd_ffn_forward.restype = ci
        lib._msmd_typed = True
    return lib


def fused_ffn_ln(x, w1, b1, w2, b2, g, b) -> torch.Tensor:
    """``LN(x + gelu(x w1^T + b1) w2^T + b2)``; x (..., F). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (bf16 x and
    weights, f32 LayerNorm parameters, F and FFN multiples of 128, F <=
    1024) or raises."""
    if _build.on_cpu("fused_ffn_ln", x):
        return ffn_ln_plain(x, w1, b1, w2, b2, g, b)
    F, FF = x.shape[-1], w1.shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    _build.check_args("fused_ffn_ln", x.device, x=(x, x.shape, bf), w1=(w1, (FF, F), bf), b1=(b1, (FF,), bf),
                      w2=(w2, (F, FF), bf), b2=(b2, (F,), bf), g=(g, (F,), f32), b=(b, (F,), f32))
    if F % 128 or FF % 128 or F > 1024:
        raise ValueError(f"fused_ffn_ln: the kernel needs F and FFN multiples of 128 and F <= 1024 (F={F}, FFN={FF})")
    R = x.numel() // F
    lib = _lib()
    out = torch.empty_like(x)
    ws = torch.empty(lib.msmd_ffn_workspace_bytes(R, F, FF), dtype=torch.uint8, device=x.device)
    rc = lib.msmd_ffn_forward(*(_build.ptr(t) for t in (x, w1, b1, w2, b2, g, b, out, ws)), R, F, FF,
                              _build.stream(x.device))
    _build.check(lib, rc, "fused_ffn_ln")
    fused_ffn_ln.launches += 1
    return out


fused_ffn_ln.launches = 0


def ffn_work(rows: int, F: int, FF: int):
    """(flops, bytes) of one call at bf16 weights and f32 LayerNorm
    parameters: two products of 2 * rows * F * FF operations; x read once,
    out written once, every parameter read once."""
    flops = 2 * 2 * rows * F * FF
    nbytes = 2 * rows * F * 2 + 2 * F * FF * 2 + (FF + F) * 2 + 2 * F * 4
    return flops, nbytes
