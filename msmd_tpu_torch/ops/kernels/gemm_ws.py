"""One product of the guided window's layer kernels K6 and K9 alone: the
warp-specialized Hopper GEMM of ``csrc/gemm_ws.cuh`` or the wmma tile of
``csrc/decoder_common.cuh``, as ``csrc/ffn.cu`` and ``csrc/layer_tail.cu``
choose between them, with its plain PyTorch version, its launch plan and
the tensor maps of its weights.

The products take their weights in the ``nn.Linear`` (out, in) layout,
``w`` (N, K): FFN1 (epilogue "gelu", K6's tanh form, or "gelu_erf", K9's
Abramowitz & Stegun erf; bf16 out) and the N = F residual products
("resid_ln": LayerNorm(res + (a w^T + bias)) with a bf16 or f32 residual,
written as bf16 only, as f32 x and its bf16 copy, or as f32 x only). The warp-specialized
GEMM takes a product with at least ``MIN_ROWS`` rows, K a multiple of 64 and
N a multiple of 256, or, for "resid_ln", N = 512 (two-CTA clusters of
128 x 256 tiles); every other product stays on the wmma tile, with a
separate LayerNorm pass. ``gemm_ws`` runs one product as the kernels do (or
on a route the caller names), for the card tests and the per-product times
of ``chip_smoke.py``; the kernels call the device functions directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _layernorm, gelu_tanh
from msmd_tpu_torch.ops.kernels.ffn_train import gelu_erf
from msmd_tpu_torch.ops.kernels.gemm import H100_SMS, MIN_ROWS, WMMA_BK, WMMA_BN

EPILOGUES = {"gelu": 0, "gelu_erf": 1, "resid_ln": 2}  # WS_GELU, WS_GELU_ERF, WS_LN
ROUTES = {"auto": 0, "wgmma_ws": 1, "wmma": 2}
OUTS = ("bf16", "x_xb", "x")

WS_BM, WS_BN, WS_BK, WS_STAGES = 128, 256, 64, 4
# the ring, 1024 bytes of alignment slack, two LayerNorm exchange buffers
# of a float4 per quad of consumer threads, and 2 * WS_STAGES + 2 mbarriers
WS_SMEM = WS_STAGES * (WS_BM + WS_BN) * WS_BK * 2 + 1024 + 2 * 64 * 16 + (2 * WS_STAGES + 2) * 8
LN_MAX_N = 1024  # the ln_kernel pass of the wmma route: one warp a row, 32 columns a lane
MAP_BYTES = 128  # sizeof(CUtensorMap)


def _wmma_smem(bm: int) -> int:
    # gemm_smem_bytes<BM, BT = true>: a 4-stage ring of BM x 32 A and 128 x 32
    # B tiles (rows padded by 8) and a 16 x 20 f32 staging tile per warp
    return 4 * (bm * (WMMA_BK + 8) + WMMA_BN * (WMMA_BK + 8)) * 2 + 8 * 16 * 20 * 4


def takes_ws(M: int, N: int, K: int, epilogue: str) -> bool:
    """Whether the warp-specialized GEMM takes the product (``ws_wide_ok``,
    ``ws_ln_ok``)."""
    if M < MIN_ROWS or K < 1 or K % WS_BK:
        return False
    return N == 2 * WS_BN if epilogue == "resid_ln" else N > 0 and N % WS_BN == 0


def gemm_ws_plan(M: int, N: int, K: int, epilogue: str, sms: int = H100_SMS) -> dict:
    """What K6 and K9 run for one product (``msmd_ws_gemm_plan``):
    ``route`` "wgmma_ws" or "wmma", the tile (rows, columns) of one block,
    the CTAs of a cluster, the tiles (of one block each), the grid (the
    persistent grid: min(tiles, SMs), or min(row blocks, SMs / 2) pairs) and
    the dynamic shared memory of a block. Raises for a shape or an
    epilogue that neither takes."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"gemm_ws: unknown epilogue {epilogue!r} (one of {sorted(EPILOGUES)})")
    if M < 1 or N < 1 or K < 1 or N % WMMA_BN or K % WMMA_BK:
        raise ValueError(f"gemm_ws: M={M}, N={N}, K={K}: needs M >= 1, N a multiple of {WMMA_BN}, "
                         f"K a multiple of {WMMA_BK}")
    ln = epilogue == "resid_ln"
    if takes_ws(M, N, K, epilogue):
        rb = -(-M // WS_BM)
        if ln:
            tiles, grid = 2 * rb, 2 * min(rb, sms // 2)
        else:
            tiles = (N // WS_BN) * rb
            grid = min(tiles, sms)
        return {"route": "wgmma_ws", "tile": (WS_BM, WS_BN), "cluster": 2 if ln else 1, "tiles": tiles,
                "grid": grid, "smem": WS_SMEM}
    if ln and N > LN_MAX_N:
        raise ValueError(f"gemm_ws: the LayerNorm pass of the wmma route takes N <= {LN_MAX_N} (N={N})")
    bm = 128 if N > 512 else 64
    tiles = (N // WMMA_BN) * -(-M // bm)
    return {"route": "wmma", "tile": (bm, WMMA_BN), "cluster": 1, "tiles": tiles, "grid": tiles,
            "smem": _wmma_smem(bm)}


def gemm_ws_plain(a, w, bias, epilogue: str, res=None, ln_scale=None, ln_bias=None, out: str = "bf16"):
    """The product in plain PyTorch with the kernels' rounding points: the
    operands as given (bf16 on the kernels' route), f32 sums and epilogue;
    ``w`` (N, K). "gelu" / "gelu_erf": (gelu(acc + bias)) in a's dtype;
    "resid_ln": x = LayerNorm(f32(res) + (acc + bias)), returned in a's
    dtype (``out`` "bf16"), as (x f32, x in a's dtype) ("x_xb") or as x
    f32 ("x")."""
    acc = a.float() @ w.float().t() + bias.float()
    if epilogue == "resid_ln":
        x = _layernorm(res.float() + acc, ln_scale.float(), ln_bias.float())
        return {"x_xb": (x, x.to(a.dtype)), "x": x}.get(out, x.to(a.dtype))
    return (gelu_tanh(acc) if epilogue == "gelu" else gelu_erf(acc)).to(a.dtype)


def _lib():
    # the entry points live in every library that includes gemm_ws.cuh; K6's
    lib = _build.load("ffn")
    if not getattr(lib, "_msmd_ws_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmd_ws_gemm.argtypes = [ci, ci] + [vp] * 4 + [ci] + [vp] * 5 + [ci] * 3 + [vp]
        lib.msmd_ws_gemm.restype = ci
        lib.msmd_ws_gemm_plan.argtypes = [ci] * 4 + [ctypes.POINTER(ctypes.c_long)]
        lib.msmd_ws_gemm_plan.restype = None
        lib.msmd_ws_weight_map.argtypes = [vp, ci, ci, vp]
        lib.msmd_ws_weight_map.restype = ci
        lib._msmd_ws_typed = True
    return lib


def kernel_plan(M: int, N: int, K: int, epilogue: str) -> Optional[dict]:
    """``msmd_ws_gemm_plan`` as the library computes it on the current
    card, in ``gemm_ws_plan``'s form (None where neither route takes the
    shape)."""
    out = (ctypes.c_long * 7)()
    _lib().msmd_ws_gemm_plan(M, N, K, EPILOGUES[epilogue], out)
    if out[0] < 0:
        return None
    return {"route": "wgmma_ws" if out[0] == 1 else "wmma", "tile": (out[1], out[2]), "cluster": out[3],
            "tiles": out[4], "grid": out[5], "smem": out[6]}


def gemm_ws(a, w, bias, epilogue: str, res=None, ln_scale=None, ln_bias=None, out: str = "bf16",
            route: str = "auto"):
    """One K6 / K9 product: a (M, K) bf16, w (N, K) bf16 (the nn.Linear
    layout), bias (N,) bf16; "resid_ln" also res (M, N) bf16 or f32 and
    ln_scale, ln_bias (N,) f32, and returns bf16 (``out`` "bf16"), (x f32,
    xb bf16) ("x_xb") or x f32 ("x"). ``route``: "auto" (what the kernels run
    at this shape), "wgmma_ws" (raises where the warp-specialized GEMM does
    not take the shape) or "wmma". A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if route not in ROUTES:
        raise ValueError(f"gemm_ws: unknown route {route!r} (one of {sorted(ROUTES)})")
    if out not in OUTS:
        raise ValueError(f"gemm_ws: unknown output {out!r} (one of {OUTS})")
    if _build.on_cpu("gemm_ws", a):
        return gemm_ws_plain(a, w, bias, epilogue, res, ln_scale, ln_bias, out)
    M, K = a.shape
    N = w.shape[0]
    plan = gemm_ws_plan(M, N, K, epilogue)
    if route == "wgmma_ws" and plan["route"] != "wgmma_ws":
        raise ValueError(f"gemm_ws: the warp-specialized GEMM does not take M={M}, N={N}, K={K} with {epilogue!r}")
    bf, f32 = torch.bfloat16, torch.float32
    named = dict(a=(a, (M, K), bf), w=(w, (N, K), bf), bias=(bias, (N,), bf))
    ln = epilogue == "resid_ln"
    if ln:
        if res is None or res.dtype not in (bf, f32):
            raise TypeError("gemm_ws: resid_ln needs res, bf16 or f32")
        named.update(res=(res, (M, N), res.dtype), ln_scale=(ln_scale, (N,), f32), ln_bias=(ln_bias, (N,), f32))
    _build.check_args("gemm_ws", a.device, **named)
    ptr, null = _build.ptr, ctypes.c_void_p(None)
    dev = a.device
    wmma = route == "wmma" or plan["route"] == "wmma"
    x = torch.empty(M, N, dtype=f32, device=dev) if ln and out != "bf16" else None
    # the bf16 output; with out "x" only the wmma route's LayerNorm pass writes one
    c = torch.empty(M, N, dtype=bf, device=dev) if out != "x" or wmma else None
    y = torch.empty(M, N, dtype=f32, device=dev) if ln and wmma else None
    opt = lambda t: ptr(t) if t is not None else null
    lib = _lib()
    rc = lib.msmd_ws_gemm(ROUTES[route], EPILOGUES[epilogue], ptr(a), ptr(w), ptr(bias), opt(res),
                          int(ln and res.dtype == f32), opt(x), opt(c), opt(ln_scale), opt(ln_bias), opt(y),
                          M, N, K, _build.stream(dev))
    _build.check(lib, rc, "gemm_ws")
    gemm_ws.launches += 1
    return {"x_xb": (x, c), "x": x}.get(out, c) if ln else c


gemm_ws.launches = 0


def gemm_ws_work(M: int, N: int, K: int, epilogue: str, res_bytes: int = 2, out: str = "bf16"):
    """(flops, bytes) of one product: 2 M N K operations; a, w and bias read
    once and the outputs written once (bf16 out unless ``out`` is "x"; for
    "resid_ln" also the residual read, f32 x written for ``out`` "x_xb" and
    "x", and ln_scale, ln_bias read)."""
    nbytes = 2 * (M * K + N * K + N) + (0 if out == "x" else 2 * M * N)
    if epilogue == "resid_ln":
        nbytes += M * N * res_bytes + (0 if out == "bf16" else 4 * M * N) + 2 * N * 4
    return 2 * M * N * K, nbytes


class WeightMaps:
    """The tensor maps of a kernel's weights for the warp-specialized GEMM,
    encoded once (``msmd_ws_weight_map``) and passed to every call that
    reads those weights at those addresses in place of encoding them there.
    ``products`` gives each weight's (N, K, epilogue): a weight whose product
    the GEMM does not take at any row count gets no map (None)."""

    def __init__(self, weights: Sequence[torch.Tensor], products: Sequence[tuple]):
        lib = _lib()
        self.key = tuple((w.data_ptr(), tuple(w.shape)) for w in weights)
        # CUtensorMap is 64-byte aligned
        self._buf = ctypes.create_string_buffer(MAP_BYTES * len(weights) + 64)
        base = (ctypes.addressof(self._buf) + 63) // 64 * 64
        self.pointers = []
        for i, (w, (N, K, epilogue)) in enumerate(zip(weights, products)):
            if not takes_ws(MIN_ROWS, N, K, epilogue):
                self.pointers.append(None)
                continue
            addr = ctypes.c_void_p(base + i * MAP_BYTES)
            _build.check(lib, lib.msmd_ws_weight_map(_build.ptr(w), N, K, addr), "msmd_ws_weight_map")
            self.pointers.append(addr)

    def for_weights(self, *weights: torch.Tensor) -> list:
        """The maps as C arguments; raises unless ``weights`` lie where the
        maps were made for."""
        if tuple((w.data_ptr(), tuple(w.shape)) for w in weights) != self.key:
            raise ValueError("WeightMaps: the weights are not those the maps were made for")
        return self.pointers
