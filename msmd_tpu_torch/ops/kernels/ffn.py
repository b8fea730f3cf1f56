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

The kernel is two products (``ffn_products``): FFN1 with the GELU epilogue
and FFN2 with the residual and the LayerNorm in its epilogue, each on the
warp-specialized GEMM of ``csrc/gemm_ws.cuh`` where that takes its shape
(``ops/kernels/gemm_ws.py``), else on the wmma tile with a LayerNorm pass.
``prepare_ffn_weights`` makes the kernel's weights (bf16 copies, f32
LayerNorm parameters, the weights' tensor maps) once, for the many calls
of a sampling window.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _layernorm, gelu_tanh
from msmd_tpu_torch.ops.kernels.ffn_train import gelu_erf
from msmd_tpu_torch.ops.kernels.gemm_ws import WeightMaps, gemm_ws_plan, gemm_ws_work


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
        lib.msmd_ffn_forward.argtypes = [vp] * 9 + [ci] * 3 + [vp] * 3
        lib.msmd_ffn_forward.restype = ci
        lib._msmd_typed = True
    return lib


def fused_ffn_ln(x, w1, b1, w2, b2, g, b, maps: Optional[WeightMaps] = None) -> torch.Tensor:
    """``LN(x + gelu(x w1^T + b1) w2^T + b2)``; x (..., F). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (bf16 x and
    weights, f32 LayerNorm parameters, F and FFN multiples of 128, F <=
    1024) or raises. ``maps``: the weights' tensor maps
    (``prepare_ffn_weights``), or None to make them in the call."""
    if _build.on_cpu("fused_ffn_ln", x):
        return ffn_ln_plain(x, w1, b1, w2, b2, g, b)
    F, FF = x.shape[-1], w1.shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    _build.check_args("fused_ffn_ln", x.device, x=(x, x.shape, bf), w1=(w1, (FF, F), bf), b1=(b1, (FF,), bf),
                      w2=(w2, (F, FF), bf), b2=(b2, (F,), bf), g=(g, (F,), f32), b=(b, (F,), f32))
    if F % 128 or FF % 128 or F > 1024:
        raise ValueError(f"fused_ffn_ln: the kernel needs F and FFN multiples of 128 and F <= 1024 (F={F}, FFN={FF})")
    map_w1, map_w2 = maps.for_weights(w1, w2) if maps is not None else (None, None)
    R = x.numel() // F
    lib = _lib()
    out = torch.empty_like(x)
    ws = torch.empty(lib.msmd_ffn_workspace_bytes(R, F, FF), dtype=torch.uint8, device=x.device)
    rc = lib.msmd_ffn_forward(*(_build.ptr(t) for t in (x, w1, b1, w2, b2, g, b, out, ws)), R, F, FF,
                              map_w1, map_w2, _build.stream(x.device))
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


def ffn_products(rows: int, F: int, FF: int) -> dict:
    """K6's two products at ``rows`` rows, in the order the kernel runs
    them: (M, N, K), the epilogue and its residual and output in
    ``gemm_ws``'s terms, the launch plan (``gemm_ws_plan``) and the work
    (``gemm_ws_work``: the products' operations sum to ``ffn_work``'s; their
    bytes also count the hidden state h, written and read again)."""
    shapes = {"ffn1": (rows, FF, F, "gelu", None, "bf16"), "ffn2": (rows, F, FF, "resid_ln", 2, "bf16")}
    out = {}
    for name, (M, N, K, epi, res_bytes, o) in shapes.items():
        flops, nbytes = gemm_ws_work(M, N, K, epi, res_bytes or 0, o)
        out[name] = {"M": M, "N": N, "K": K, "epilogue": epi, "res": "bf16" if res_bytes else None, "out": o,
                     "plan": gemm_ws_plan(M, N, K, epi), "flops": flops, "bytes": nbytes}
    return out


class FfnWeights(NamedTuple):
    """K6's weights as the kernel takes them: ``fused_ffn_ln(x, *weights)``."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    maps: Optional[WeightMaps]


def prepare_ffn_weights(w1, b1, w2, b2, g, b, dtype) -> FfnWeights:
    """K6's weights made once: ``dtype`` copies of the weights and biases
    (the nn.Linear layout; no copy where they are ``dtype`` already), the
    LayerNorm parameters in f32 and, for bf16 weights on the card, the
    weights' tensor maps. Detached: the kernel runs in eval mode only."""
    w1, b1, w2, b2 = (t.detach().to(dtype).contiguous() for t in (w1, b1, w2, b2))
    g, b = g.detach().float().contiguous(), b.detach().float().contiguous()
    maps = None
    if w1.device.type == "cuda" and dtype == torch.bfloat16:
        F, FF = w2.shape[0], w1.shape[0]
        maps = WeightMaps((w1, w2), ((FF, F, "gelu"), (F, FF, "resid_ln")))
    return FfnWeights(w1, b1, w2, b2, g, b, maps)
