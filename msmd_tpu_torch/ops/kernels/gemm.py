"""One product of the decoder stack alone: the Hopper GEMM of
``csrc/gemm_sm90.cuh`` (wgmma on the warp-specialised pipeline it shares
with K6 and K9) or the wmma tile of ``csrc/decoder_common.cuh``, as K1
chooses between them, with its plain PyTorch version and its launch plan.

K1 (``csrc/decoder.cu``) runs four products per layer: QKV (N = 3F, bf16
out, q columns scaled), self-out (N = F, residual and LayerNorm, then on
the motion rows the identity band's cross step and its LayerNorm:
"resid_ln_cross"), FFN1 (N = FFN, tanh GELU) and FFN2 (N = F, residual
and LayerNorm). The Hopper GEMM takes a product with at least
``MIN_ROWS`` rows, K a multiple of 64 and N a multiple of 256 (128 x 256
tiles), or, for the LayerNorm epilogues, N = 512 (two-CTA clusters, each
CTA 128 x 256 of the same rows); every other product stays on the wmma
tile, whose LayerNorm is a separate pass. ``gemm`` runs one product as
the decoder does (or on a route the caller names: "sm90_loop" is the
256-thread tile loop that K2 runs and K1 ran before, bit-equal to the
Hopper route), for the card tests and the per-product times of
``chip_smoke.py``; the decoder itself calls the device functions
directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _layernorm, gelu_tanh

EPI_BF16, EPI_GELU, EPI_RESID_LN, EPI_RESID_LN_CROSS = 0, 2, 6, 7  # csrc/decoder_common.cuh, csrc/gemm_sm90.cuh
EPILOGUES = {"bf16": EPI_BF16, "gelu": EPI_GELU, "resid_ln": EPI_RESID_LN, "resid_ln_cross": EPI_RESID_LN_CROSS}
ROUTES = {"auto": 0, "wgmma": 1, "wmma": 2, "sm90_loop": 3}

MIN_ROWS = 1024  # SM90_MIN_ROWS: K4 (<= 512 rows) keeps the wmma tile; K3 and K1 flat run decoder_small.cuh
SM90_BK = 64
WMMA_BN, WMMA_BK = 128, 32
H100_SMS = 132
# the warp-specialised pipeline (gemm_sm90.cuh): 128 x 256 CTA tiles, a ring of 4 stages of A (128 x 64)
# and B (256 x 64) bf16, 1024 bytes of alignment slack, two LayerNorm exchange buffers of 128 floats x 2,
# 10 mbarriers
WS_BM, WS_BN, WS_STAGES = 128, 256, 4
WS_SMEM = WS_STAGES * (WS_BM + WS_BN) * SM90_BK * 2 + 1024 + 2 * 2 * WS_BM * 4 + (2 * WS_STAGES + 2) * 8
# and K1's LayerNorm products' table of per-column parameters (f32 x 256 columns): bias, ln_scale, ln_bias,
# and for the cross epilogue bco, ln2_scale, ln2_bias
WS_COLUMN_PARAMS = {"resid_ln": 3, "resid_ln_cross": 6}


def _wmma_smem(bm: int) -> int:
    # gemm_smem_bytes<BM>: a 4-stage ring of BM x 32 A and 32 x 128 B tiles
    # (rows padded by 8) and a 16 x 20 f32 staging tile per warp
    return 4 * (bm * (WMMA_BK + 8) + WMMA_BK * (WMMA_BN + 8)) * 2 + 8 * 16 * 20 * 4


def hopper_takes(M: int, N: int, K: int, epilogue: str) -> bool:
    """Whether the Hopper GEMM takes the product (``sm90_wide_ok`` /
    ``sm90_ln_ok``)."""
    ln = epilogue in ("resid_ln", "resid_ln_cross")
    return M >= MIN_ROWS and K % SM90_BK == 0 and (N == 512 if ln else N % 256 == 0)


def gemm_plan(M: int, N: int, K: int, epilogue: str, sms: int = H100_SMS) -> dict:
    """What the decoder runs for one product (``msmd_gemm_plan``):
    ``route`` "wgmma" or "wmma", the tile of a CTA (rows, columns), CTAs a
    ``cluster``, ``clusters``, ``tiles`` (of one CTA), the ``grid`` (the
    Hopper GEMM's persistent grid: min(tiles, SMs) blocks, or for the
    LayerNorm epilogues min(row blocks, SMs / 2) clusters of two) and the
    dynamic shared memory of a block. Raises for a shape or an epilogue
    that neither takes ("resid_ln_cross" runs only on the Hopper GEMM)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"gemm: unknown epilogue {epilogue!r} (one of {sorted(EPILOGUES)})")
    if M < 1 or N % WMMA_BN or K % WMMA_BK:
        raise ValueError(f"gemm: M={M}, N={N}, K={K}: needs M >= 1, N a multiple of {WMMA_BN}, "
                         f"K a multiple of {WMMA_BK}")
    ln = epilogue in ("resid_ln", "resid_ln_cross")
    if hopper_takes(M, N, K, epilogue):
        rb = -(-M // WS_BM)
        if ln:  # two CTAs a row block, one per 256-column half
            clusters = min(rb, sms // 2)
            return {"route": "wgmma", "tile": (WS_BM, WS_BN), "cluster": 2, "clusters": clusters, "tiles": 2 * rb,
                    "grid": 2 * clusters, "smem": WS_SMEM + WS_COLUMN_PARAMS[epilogue] * WS_BN * 4}
        tiles = (N // WS_BN) * rb
        return {"route": "wgmma", "tile": (WS_BM, WS_BN), "cluster": 1, "clusters": min(tiles, sms), "tiles": tiles,
                "grid": min(tiles, sms), "smem": WS_SMEM}
    if epilogue == "resid_ln_cross":
        raise ValueError(f"gemm: 'resid_ln_cross' runs only on the Hopper GEMM, which does not take M={M}, N={N}, "
                         f"K={K}")
    bm = 128 if N > 512 else 64
    tiles = (N // WMMA_BN) * -(-M // bm)
    return {"route": "wmma", "tile": (bm, WMMA_BN), "cluster": 1, "clusters": tiles, "tiles": tiles, "grid": tiles,
            "smem": _wmma_smem(bm)}


def gemm_plain(a, b, bias, epilogue: str, res=None, ln_scale=None, ln_bias=None, scale: float = 1.0,
               scale_cols: int = 0, vmw=None, bco=None, ln2_scale=None, ln2_bias=None, aux=None, lq: int = 1):
    """The product in plain PyTorch with the kernels' rounding points: bf16
    operands, f32 sums and epilogue. "bf16": bf16(acc + bias, columns <
    scale_cols times scale); "gelu": bf16(gelu_tanh(acc + bias));
    "resid_ln": (x f32, xb bf16) = LayerNorm(res + (acc + bias));
    "resid_ln_cross": "resid_ln", then on every row that is not a person
    row (``aux[row // lq] == row``) LayerNorm(x + (vmw + bco)) with
    ln2_scale, ln2_bias."""
    acc = a.float() @ b.float() + bias.float()
    if epilogue in ("resid_ln", "resid_ln_cross"):
        x = _layernorm(res.float() + acc, ln_scale.float(), ln_bias.float())
        if epilogue == "resid_ln_cross":
            rows = torch.arange(x.shape[0], device=x.device)
            motion = aux.long()[rows // lq] != rows
            cross = _layernorm(x + (vmw.float() + bco.float()), ln2_scale.float(), ln2_bias.float())
            x = torch.where(motion[:, None], cross, x)
        return x, x.to(torch.bfloat16)
    if epilogue == "gelu":
        return gelu_tanh(acc).to(torch.bfloat16)
    acc[:, :scale_cols] = acc[:, :scale_cols] * scale
    return acc.to(torch.bfloat16)


def _lib():
    lib = _build.load("decoder")
    if not getattr(lib, "_msmd_gemm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmd_gemm.argtypes = [ci, ci] + [vp] * 9 + [ci] * 3 + [ctypes.c_float, ci] + [vp] * 5 + [ci, vp]
        lib.msmd_gemm.restype = ci
        lib.msmd_gemm_plan.argtypes = [ci] * 4 + [ctypes.POINTER(ctypes.c_long)]
        lib.msmd_gemm_plan.restype = None
        lib._msmd_gemm_typed = True
    return lib


def kernel_plan(M: int, N: int, K: int, epilogue: str) -> Optional[dict]:
    """``msmd_gemm_plan`` as the library computes it on the current card,
    in ``gemm_plan``'s form (None where neither route takes the shape)."""
    out = (ctypes.c_long * 8)()
    _lib().msmd_gemm_plan(M, N, K, EPILOGUES[epilogue], out)
    if out[0] < 0:
        return None
    return {"route": "wgmma" if out[0] == 1 else "wmma", "tile": (out[1], out[2]), "cluster": out[3],
            "clusters": out[4], "tiles": out[5], "grid": out[6], "smem": out[7]}


def gemm(a, b, bias, epilogue: str, res=None, ln_scale=None, ln_bias=None, scale: float = 1.0,
         scale_cols: int = 0, vmw=None, bco=None, ln2_scale=None, ln2_bias=None, aux=None, lq: int = 1,
         route: str = "auto"):
    """One decoder product: a (M, K) bf16, b (K, N) bf16 (the (in, out)
    layout), bias (N,) bf16; "resid_ln" also res (M, N) f32 and ln_scale,
    ln_bias (N,) f32 and returns (x, xb); "resid_ln_cross" also vmw (M, N)
    bf16, bco (N,) bf16, ln2_scale, ln2_bias (N,) f32 and the person rows
    aux (ceil(M / lq),) int32. ``route``: "auto" (what the decoder runs at
    this shape), "wgmma" (raises where the Hopper GEMM does not take the
    shape), "wmma", or "sm90_loop" (the Hopper GEMM's tile loop that K2
    runs; raises as "wgmma"). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if _build.on_cpu("gemm", a):
        return gemm_plain(a, b, bias, epilogue, res, ln_scale, ln_bias, scale, scale_cols, vmw, bco, ln2_scale,
                          ln2_bias, aux, lq)
    M, K = a.shape
    N = b.shape[1]
    plan = gemm_plan(M, N, K, epilogue)
    if route not in ROUTES:
        raise ValueError(f"gemm: unknown route {route!r} (one of {sorted(ROUTES)})")
    if route in ("wgmma", "sm90_loop") and plan["route"] != "wgmma":
        raise ValueError(f"gemm: the Hopper GEMM does not take M={M}, N={N}, K={K} with {epilogue!r}")
    cross = epilogue == "resid_ln_cross"
    if cross and route == "wmma":
        raise ValueError("gemm: 'resid_ln_cross' runs only on the Hopper GEMM")
    bf, f32 = torch.bfloat16, torch.float32
    named = dict(a=(a, (M, K), bf), b=(b, (K, N), bf), bias=(bias, (N,), bf))
    ln = epilogue in ("resid_ln", "resid_ln_cross")
    if ln:
        named.update(res=(res, (M, N), f32), ln_scale=(ln_scale, (N,), f32), ln_bias=(ln_bias, (N,), f32))
    if cross:
        named.update(vmw=(vmw, (M, N), bf), bco=(bco, (N,), bf), ln2_scale=(ln2_scale, (N,), f32),
                     ln2_bias=(ln2_bias, (N,), f32), aux=(aux, (-(-M // lq),), torch.int32))
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
    extra = [ptr(vmw), ptr(bco), ptr(ln2_scale), ptr(ln2_bias), ptr(aux)] if cross else [null] * 5
    lib = _lib()
    rc = lib.msmd_gemm(ROUTES[route], EPILOGUES[epilogue], *ptrs, M, N, K, scale, scale_cols, *extra, lq,
                       _build.stream(a.device))
    _build.check(lib, rc, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0


def gemm_work(M: int, N: int, K: int, epilogue: str):
    """(flops, bytes) of one product: 2 M N K operations; a, b and bias
    read once and the output written once (plus res read and xb written
    for the LayerNorm epilogues, and vmw read for "resid_ln_cross")."""
    nbytes = 2 * (M * K + K * N + N)
    if epilogue in ("resid_ln", "resid_ln_cross"):
        nbytes += M * N * (4 + 4 + 2) + 2 * N * 4  # res in; x, xb out; ln_scale, ln_bias
        if epilogue == "resid_ln_cross":
            nbytes += M * N * 2 + N * 2 + 2 * N * 4  # vmw, bco, ln2_scale, ln2_bias
    else:
        nbytes += M * N * 2
    return 2 * M * N * K, nbytes
