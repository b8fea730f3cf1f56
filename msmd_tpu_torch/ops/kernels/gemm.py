"""One product of the decoder stack alone: the Hopper GEMM of
``csrc/gemm_sm90.cuh`` (wgmma) or the wmma tile of
``csrc/decoder_common.cuh``, as K1 and K2 choose between them, with its
plain PyTorch version and its launch plan.

K1 (``csrc/decoder.cu``) and K2 run four products per layer: QKV (N = 3F,
bf16 out, q columns scaled), self-out (N = F, residual and LayerNorm),
FFN1 (N = FFN, tanh GELU) and FFN2 (N = F, residual and LayerNorm). The
Hopper GEMM takes a product with at least ``MIN_ROWS`` rows, K a multiple
of 64 and N a multiple of 256, or, for the residual + LayerNorm epilogue,
N = 512 (one block holds whole rows); every other product stays on the
wmma tile, whose LayerNorm is a separate pass. ``gemm`` runs one product
as the decoder does (or on a route the caller names), for the card tests
and the per-product times of ``chip_smoke.py``; the decoder itself calls
the device functions directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _layernorm, gelu_tanh

EPI_BF16, EPI_GELU, EPI_RESID_LN = 0, 2, 6  # csrc/decoder_common.cuh, csrc/gemm_sm90.cuh
EPILOGUES = {"bf16": EPI_BF16, "gelu": EPI_GELU, "resid_ln": EPI_RESID_LN}
ROUTES = {"auto": 0, "wgmma": 1, "wmma": 2}

MIN_ROWS = 1024  # SM90_MIN_ROWS: K4 (<= 512 rows) keeps the wmma tile; K3 and K1 flat run decoder_small.cuh
SM90_BK = 64
WMMA_BN, WMMA_BK = 128, 32
H100_SMS = 132


def _wmma_smem(bm: int) -> int:
    # gemm_smem_bytes<BM>: a 4-stage ring of BM x 32 A and 32 x 128 B tiles
    # (rows padded by 8) and a 16 x 20 f32 staging tile per warp
    return 4 * (bm * (WMMA_BK + 8) + WMMA_BK * (WMMA_BN + 8)) * 2 + 8 * 16 * 20 * 4


def gemm_plan(M: int, N: int, K: int, epilogue: str, sms: int = H100_SMS) -> dict:
    """What the decoder runs for one product (``msmd_gemm_plan``):
    ``route`` "wgmma" or "wmma", the tile (rows, columns), the number of
    tiles, the grid (the Hopper GEMM's persistent grid is min(tiles, SMs))
    and the dynamic shared memory of a block. Raises for a shape or an
    epilogue that neither takes."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"gemm: unknown epilogue {epilogue!r} (one of {sorted(EPILOGUES)})")
    if M < 1 or N % WMMA_BN or K % WMMA_BK:
        raise ValueError(f"gemm: M={M}, N={N}, K={K}: needs M >= 1, N a multiple of {WMMA_BN}, "
                         f"K a multiple of {WMMA_BK}")
    ln = epilogue == "resid_ln"
    fits = M >= MIN_ROWS and K % SM90_BK == 0 and (N == 512 if ln else N % 256 == 0)
    if fits:
        wgm = 1 if ln else 2  # warpgroups stacked in M (128 x 256), or side by side in N (64 x 512)
        bm, bn, stages = 64 * wgm, 256 * (2 // wgm), 3 if ln else 4
        tiles = (N // bn) * -(-M // bm)
        return {"route": "wgmma", "tile": (bm, bn), "tiles": tiles, "grid": min(tiles, sms),
                "smem": stages * (bm + bn) * 128 + 1024 + 4 * 64 * 4 + 8 * stages}
    bm = 128 if N > 512 else 64
    tiles = (N // WMMA_BN) * -(-M // bm)
    return {"route": "wmma", "tile": (bm, WMMA_BN), "tiles": tiles, "grid": tiles, "smem": _wmma_smem(bm)}


def gemm_plain(a, b, bias, epilogue: str, res=None, ln_scale=None, ln_bias=None, scale: float = 1.0,
               scale_cols: int = 0):
    """The product in plain PyTorch with the kernels' rounding points: bf16
    operands, f32 sums and epilogue. "bf16": bf16(acc + bias, columns <
    scale_cols times scale); "gelu": bf16(gelu_tanh(acc + bias));
    "resid_ln": (x f32, xb bf16) = LayerNorm(res + (acc + bias))."""
    acc = a.float() @ b.float() + bias.float()
    if epilogue == "resid_ln":
        x = _layernorm(res.float() + acc, ln_scale.float(), ln_bias.float())
        return x, x.to(torch.bfloat16)
    if epilogue == "gelu":
        return gelu_tanh(acc).to(torch.bfloat16)
    acc[:, :scale_cols] = acc[:, :scale_cols] * scale
    return acc.to(torch.bfloat16)


def _lib():
    lib = _build.load("decoder")
    if not getattr(lib, "_msmd_gemm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmd_gemm.argtypes = [ci, ci] + [vp] * 9 + [ci] * 3 + [ctypes.c_float, ci, vp]
        lib.msmd_gemm.restype = ci
        lib.msmd_gemm_plan.argtypes = [ci] * 4 + [ctypes.POINTER(ctypes.c_long)]
        lib.msmd_gemm_plan.restype = None
        lib._msmd_gemm_typed = True
    return lib


def kernel_plan(M: int, N: int, K: int, epilogue: str) -> Optional[dict]:
    """``msmd_gemm_plan`` as the library computes it on the current card,
    in ``gemm_plan``'s form (None where neither route takes the shape)."""
    out = (ctypes.c_long * 6)()
    _lib().msmd_gemm_plan(M, N, K, EPILOGUES[epilogue], out)
    if out[0] < 0:
        return None
    return {"route": "wgmma" if out[0] == 1 else "wmma", "tile": (out[1], out[2]), "tiles": out[3],
            "grid": out[4], "smem": out[5]}


def gemm(a, b, bias, epilogue: str, res=None, ln_scale=None, ln_bias=None, scale: float = 1.0,
         scale_cols: int = 0, route: str = "auto"):
    """One decoder product: a (M, K) bf16, b (K, N) bf16 (the (in, out)
    layout), bias (N,) bf16; "resid_ln" also res (M, N) f32 and ln_scale,
    ln_bias (N,) f32 and returns (x, xb). ``route``: "auto" (what the
    decoder runs at this shape), "wgmma" (raises where the Hopper GEMM does
    not take the shape) or "wmma". A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if _build.on_cpu("gemm", a):
        return gemm_plain(a, b, bias, epilogue, res, ln_scale, ln_bias, scale, scale_cols)
    M, K = a.shape
    N = b.shape[1]
    plan = gemm_plan(M, N, K, epilogue)
    if route not in ROUTES:
        raise ValueError(f"gemm: unknown route {route!r} (one of {sorted(ROUTES)})")
    if route == "wgmma" and plan["route"] != "wgmma":
        raise ValueError(f"gemm: the Hopper GEMM does not take M={M}, N={N}, K={K} with {epilogue!r}")
    bf, f32 = torch.bfloat16, torch.float32
    named = dict(a=(a, (M, K), bf), b=(b, (K, N), bf), bias=(bias, (N,), bf))
    ln = epilogue == "resid_ln"
    if ln:
        named.update(res=(res, (M, N), f32), ln_scale=(ln_scale, (N,), f32), ln_bias=(ln_bias, (N,), f32))
    _build.check_args("gemm", a.device, **named)
    ptr, null = _build.ptr, ctypes.c_void_p(None)
    if ln:
        x = torch.empty(M, N, dtype=f32, device=a.device)
        xb = torch.empty(M, N, dtype=bf, device=a.device)
        y = torch.empty(M, N, dtype=f32, device=a.device) if plan["route"] == "wmma" or route == "wmma" else None
        ptrs = [ptr(a), ptr(b), ptr(bias), ptr(res), ptr(x), ptr(xb), ptr(ln_scale), ptr(ln_bias),
                ptr(y) if y is not None else null]
        out = (x, xb)
    else:
        c = torch.empty(M, N, dtype=bf, device=a.device)
        ptrs = [ptr(a), ptr(b), ptr(bias), null, ptr(c), null, null, null, null]
        out = c
    lib = _lib()
    rc = lib.msmd_gemm(ROUTES[route], EPILOGUES[epilogue], *ptrs, M, N, K, scale, scale_cols,
                       _build.stream(a.device))
    _build.check(lib, rc, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0


def gemm_work(M: int, N: int, K: int, epilogue: str):
    """(flops, bytes) of one product: 2 M N K operations; a, b and bias
    read once and the output written once (plus res read and xb written
    for "resid_ln")."""
    nbytes = 2 * (M * K + K * N + N)
    if epilogue == "resid_ln":
        nbytes += M * N * (4 + 4 + 2) + 2 * N * 4  # res in; x, xb out; ln_scale, ln_bias
    else:
        nbytes += M * N * 2
    return 2 * M * N * K, nbytes
