"""K8, the per-entry, unmasked self-attention middle: a hand-written CUDA
kernel (``csrc/attn.cu``) and its plain PyTorch version.

Replaces ``msmd_tpu/ops/pallas/attn_kernel.py::attention_middle``:
``softmax(q k^T / sqrt(dh)) v`` per batch entry and head, from projected
q, k, v (B, lq, F), with no mask. Both versions round where
``_attn_mid_kernel`` rounds, which is not the decoder kernel K1's "fast"
softmax: q is scaled by 1/sqrt(dh) in f32 and then cast to the input
dtype; the scores are f32; the softmax is exact and subtracts the row
max (``jax.nn.softmax``) and is normalised before the PV product, with P
cast to the input dtype; the PV sums are f32; the output takes the input
dtype.

The kernel takes bf16 with head dim 64, any B, and lq up to 256 (one
warp per 16 query rows; it raises past it, naming the shape). The scores
and P never leave registers (``csrc/attn.cu``). q, k and v may be column
slices of one (B, lq, 3F) projection. The JAX layer takes its kernel
only where ``attn_middle_viable`` finds an 8-aligned row tile (a TPU
sublane limit, ``msmd_tpu/models/transformer.py``:177).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from msmd_tpu_torch import _build

MAX_LQ = 256  # rows per entry the kernel takes: 16 warps of 16 query rows


def attn_plan(B: int, lq: int, n_heads: int) -> dict:
    """The launch ``csrc/attn.cu`` makes for (B, lq, heads): B x heads
    (entry, head) items walked by a persistent grid (as many blocks as the
    card holds at once, from the occupancy query, at most one per item),
    one warp per 16 query rows, two buffers of q, k and v of a head in
    shared memory (2 x 3 x lp x 128 bytes, lp = lq rounded up to 16).
    Raises for a shape the kernel does not take, naming it."""
    if B < 1 or n_heads < 1:
        raise ValueError(f"attention_middle: B={B}, heads={n_heads} must be positive")
    if not 1 <= lq <= MAX_LQ:
        raise ValueError(f"attention_middle: lq={lq} (B={B}) is outside the kernel's 1..{MAX_LQ} rows per entry")
    nt = (lq + 15) // 16
    return {"items": B * n_heads, "warps": nt, "threads": 32 * nt, "smem": 2 * 3 * 16 * nt * 128}


def attn_kernel_takes(B: int, lq: int, F: int, n_heads: int) -> bool:
    """Whether ``attention_middle`` takes (B, lq, F, heads) on the card: the
    row count ``attn_plan`` accepts (1..``MAX_LQ``) and whole heads. The
    port's layers route a self-attention with ``attn_kernel`` on through
    K8 only where this holds, and through the plain attention otherwise
    (a style clip longer than ``MAX_LQ`` frames)."""
    return B >= 1 and n_heads >= 1 and 1 <= lq <= MAX_LQ and F % n_heads == 0


F32_QTILE = 32  # query rows of one block of the f32 mode


def attn_f32_plan(B: int, lq: int, n_heads: int) -> dict:
    """The launch of the f32 mode (``attn_f32_kernel``): one 256-thread
    block per (entry, head, tile of 32 query rows), K (rows padded to 65
    floats) and V of the head, the tile's Q and its P rows in shared
    memory, key columns in groups of 32 (``nc``). Raises as ``attn_plan``."""
    attn_plan(B, lq, n_heads)
    nc = (lq + 31) // 32
    tiles = (lq + F32_QTILE - 1) // F32_QTILE
    kp = 32 * nc
    smem = 4 * (kp * 65 + lq * 64 + F32_QTILE * 64 + F32_QTILE * kp)
    return {"blocks": B * n_heads * tiles, "threads": 256, "tiles": tiles, "nc": nc, "smem": smem}


def attention_middle_plain(q, k, v, n_heads: int) -> torch.Tensor:
    """K8 in plain PyTorch. q, k, v (B, lq, F) -> (B, lq, F) in q's dtype."""
    B, lq, F = q.shape
    dh = F // n_heads
    cdt = q.dtype
    heads = lambda t: t.reshape(B, lq, n_heads, dh).transpose(1, 2).float()
    qh = (heads(q) * np.float32(1.0 / np.sqrt(dh))).to(cdt).float()
    p = torch.softmax(qh @ heads(k).transpose(-1, -2), dim=-1)
    out = p.to(cdt).float() @ heads(v)
    return out.transpose(1, 2).reshape(B, lq, F).to(cdt)


def _lib():
    lib = _build.load("attn")
    if not getattr(lib, "_msmd_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmd_attn_smem_bytes.argtypes = [ci]
        lib.msmd_attn_smem_bytes.restype = ctypes.c_size_t
        lib.msmd_attn_forward.argtypes = [vp] * 3 + [ctypes.c_long, vp] + [ci] * 4 + [vp]
        lib.msmd_attn_forward.restype = ci
        lib.msmd_attn_f32_forward.argtypes = [vp] * 3 + [ctypes.c_long, vp] + [ci] * 4 + [vp]
        lib.msmd_attn_f32_forward.restype = ci
        lib.msmd_attn_f32_smem_bytes.argtypes = [ci]
        lib.msmd_attn_f32_smem_bytes.restype = ctypes.c_size_t
        lib._msmd_typed = True
    return lib


def _check(q, k, v, n_heads: int, dtype=torch.bfloat16) -> int:
    """Raise unless the kernel of ``dtype`` takes (q, k, v); returns their
    row stride (16-byte aligned rows)."""
    B, lq, F = q.shape
    per16 = 128 // torch.finfo(dtype).bits  # elements in 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"attention_middle: {name} must be on {q.device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"attention_middle: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != (B, lq, F):
            raise ValueError(f"attention_middle: {name} has shape {tuple(t.shape)}, expected {(B, lq, F)}")
    ld = q.stride(1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1 or t.stride(1) != ld or t.stride(0) != lq * ld or ld % per16 or t.data_ptr() % 16:
            raise ValueError(f"attention_middle: {name} must be contiguous rows of one row stride "
                             f"(strides {t.stride()}, q's row stride {ld})")
    if F != 64 * n_heads:
        raise ValueError(f"attention_middle: the kernel needs head dim 64 (F={F}, heads={n_heads})")
    return ld


def attention_middle(q, k, v, n_heads: int) -> torch.Tensor:
    """Per-entry ``softmax(q k^T / sqrt(dh)) v``; q, k, v (B, lq, F) ->
    (B, lq, F). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16, or f32 through ``attention_middle_f32``;
    head dim 64) or raises."""
    if _build.on_cpu("attention_middle", q):
        return attention_middle_plain(q, k, v, n_heads)
    if q.dtype == torch.float32:
        return attention_middle_f32(q, k, v, n_heads)
    ld = _check(q, k, v, n_heads)
    B, lq, F = q.shape
    attn_plan(B, lq, n_heads)
    lib = _lib()
    out = torch.empty(B, lq, F, dtype=q.dtype, device=q.device)
    rc = lib.msmd_attn_forward(_build.ptr(q), _build.ptr(k), _build.ptr(v), ld, _build.ptr(out), B, lq, F,
                               n_heads, _build.stream(q.device))
    _build.check(lib, rc, "attention_middle")
    attention_middle.launches += 1
    return out


attention_middle.launches = 0


def attention_middle_f32(q, k, v, n_heads: int) -> torch.Tensor:
    """K8's f32 mode: ``attention_middle`` of f32 q, k, v (B, lq, F), head
    dim 64, in f32 on the CUDA cores (``attn_f32_kernel``). A CPU tensor
    takes the plain version."""
    if _build.on_cpu("attention_middle_f32", q):
        return attention_middle_plain(q, k, v, n_heads)
    ld = _check(q, k, v, n_heads, torch.float32)
    B, lq, F = q.shape
    attn_f32_plan(B, lq, n_heads)
    lib = _lib()
    out = torch.empty(B, lq, F, dtype=q.dtype, device=q.device)
    rc = lib.msmd_attn_f32_forward(_build.ptr(q), _build.ptr(k), _build.ptr(v), ld, _build.ptr(out), B, lq, F,
                                   n_heads, _build.stream(q.device))
    _build.check(lib, rc, "attention_middle_f32")
    attention_middle_f32.launches += 1
    return out


attention_middle_f32.launches = 0


def attn_work(B: int, lq: int, F: int, dtype=torch.bfloat16):
    """(flops, bytes) of one call: q k^T and P v, each 2 * B * lq * lq * F
    operations over all heads; q, k, v read once, out written once, in
    ``dtype``."""
    return 2 * 2 * B * lq * lq * F, 4 * B * lq * F * torch.finfo(dtype).bits // 8
