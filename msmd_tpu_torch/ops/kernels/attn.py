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
and P never leave registers (``csrc/attn.cu``). Its f32 mode (the style
encoders') takes the same shapes in f32: CTAs of 64 query rows of one
(entry, head), both products as three TF32 tensor-core products each
(``attn_f32_plan``, ``attention_middle_f32_model``). q, k and v may be
column slices of one (B, lq, 3F) projection. The JAX layer takes its kernel
only where ``attn_middle_viable`` finds an 8-aligned row tile (a TPU
sublane limit, ``msmd_tpu/models/transformer.py``:177).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from msmd_tpu_torch import _build

MAX_LQ = 256  # rows per entry the kernel takes: 16 warps of 16 query rows
_F32 = torch.float32


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


F32_WARPS = 4  # warps of one CTA of the f32 mode, each 16 query rows (an m16 tile)
F32_ROW_STRIDE = 68  # floats a row of Q, K and V in shared memory (64 dims and 4 of padding)
F32_STAMPS = 6  # int64 a CTA of ``attn_f32_stamps``


def attn_f32_plan(B: int, lq: int, n_heads: int) -> dict:
    """The launch of the f32 mode (``attn_f32_kernel``): ``ctas_per_head``
    CTAs per (entry, head), each ``F32_WARPS`` warps of 16 query rows
    (``query_rows`` a CTA) holding the head's K and V in shared memory; the
    scores of a warp are ``2 nc`` tiles of 8 keys (16 ``nc`` >= lq). Shared
    memory a CTA: K, V and the TF32 lo plane of one of them (16 ``nc`` rows
    each) and the CTA's Q rows, at 68 floats a row. Raises as
    ``attn_plan``."""
    attn_plan(B, lq, n_heads)
    rows = 16 * F32_WARPS
    ctas, nc = -(-lq // rows), -(-lq // 16)
    return {"grid": B * n_heads * ctas, "ctas_per_head": ctas, "threads": 32 * F32_WARPS, "query_rows": rows,
            "nc": nc, "smem": 4 * (3 * 16 * nc + rows) * F32_ROW_STRIDE, "launches": 1}


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


def attention_middle_f32_model(q, k, v, n_heads: int, passes: int = 3) -> torch.Tensor:
    """The f32 mode's arithmetic in plain PyTorch: ``attention_middle_plain``
    at f32 with both products as the kernel runs them on the tensor cores,
    three TF32 products summed in f32 (lo.hi + hi.lo + hi.hi, each operand
    split by ``lbs.tf32_split_plain``; ``passes=1``: hi.hi alone, one TF32
    product): the scores from q / sqrt(dh) and k, the output from P and v.
    Each TF32 product is exact in f32; the sums run in another order than
    the tensor cores'. q, k, v (B, lq, F) f32."""
    from msmd_tpu_torch.ops.kernels.lbs import tf32_split_plain

    if passes not in (1, 3):
        raise ValueError(f"attention_middle_f32_model: passes must be 1 or 3, got {passes}")
    B, lq, F = q.shape
    dh = F // n_heads
    heads = lambda t: t.reshape(B, lq, n_heads, dh).transpose(1, 2).float()

    def product(a, b):
        (a_hi, a_lo), (b_hi, b_lo) = tf32_split_plain(a), tf32_split_plain(b)
        return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi if passes == 3 else a_hi @ b_hi

    p = torch.softmax(product(heads(q) * np.float32(1.0 / np.sqrt(dh)), heads(k).transpose(-1, -2)), dim=-1)
    return product(p, heads(v)).transpose(1, 2).reshape(B, lq, F)


def _lib():
    lib = _build.load("attn")
    if not getattr(lib, "_msmd_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmd_attn_smem_bytes.argtypes = [ci]
        lib.msmd_attn_smem_bytes.restype = ctypes.c_size_t
        lib.msmd_attn_forward.argtypes = [vp] * 3 + [ctypes.c_long, vp] + [ci] * 4 + [vp]
        lib.msmd_attn_forward.restype = ci
        lib.msmd_attn_f32_forward.argtypes = [vp] * 3 + [ctypes.c_long, vp] + [ci] * 3 + [vp, vp]
        lib.msmd_attn_f32_forward.restype = ci
        lib.msmd_attn_f32_plan.argtypes = [ci] * 3 + [ctypes.POINTER(ctypes.c_long)]
        lib.msmd_attn_f32_plan.restype = ci
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
    if q.is_cuda and q.dtype is _F32:  # the style encoders' call, whose host time counts
        return _launch_f32(q, k, v, n_heads)
    if _build.on_cpu("attention_middle", q):
        return attention_middle_plain(q, k, v, n_heads)
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
    dim 64, at f32 accuracy on the tensor cores (``attn_f32_kernel``: three
    TF32 products a product, ``attention_middle_f32_model``). A CPU tensor
    takes the plain version."""
    if _build.on_cpu("attention_middle_f32", q):
        return attention_middle_plain(q, k, v, n_heads)
    return _launch_f32(q, k, v, n_heads)


attention_middle_f32.launches = 0
_f32_entry = None  # the typed msmd_attn_f32_forward


def _check_f32(q, k, v, n_heads: int):
    """``_check`` and ``attn_plan``'s refusals for the f32 mode in one pass
    over q, k, v (the call's host time is most of it at B = 1; the kernel
    takes every shape they pass): returns the row stride, q's device index
    and the three data pointers, or raises as they do. ``get_device`` tells
    the devices apart (-1 for the CPU), so the CPU tests reach every
    branch."""
    B, lq, F = shape = q.shape
    st = q.stride()
    ld, dev = st[1], q.get_device()
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (q.dtype is _F32 and k.dtype is _F32 and v.dtype is _F32 and k.shape == shape and v.shape == shape
            and k.stride() == st and v.stride() == st and st[2] == 1 and st[0] == lq * ld and ld % 4 == 0
            and not (ptrs[0] | ptrs[1] | ptrs[2]) % 16 and k.get_device() == dev and v.get_device() == dev
            and n_heads >= 1 and F == 64 * n_heads and B >= 1 and 1 <= lq <= MAX_LQ):
        return ld, dev, ptrs
    _check(q, k, v, n_heads, _F32)
    attn_plan(B, lq, n_heads)
    raise AssertionError("attention_middle_f32: _check_f32 refused what _check and attn_plan take")


def _launch_f32(q, k, v, n_heads: int, stamps=None) -> torch.Tensor:
    global _f32_entry
    ld, dev, (qp, kp, vp) = _check_f32(q, k, v, n_heads)
    B, lq, F = q.shape
    if _f32_entry is None:
        _f32_entry = _lib().msmd_attn_f32_forward
    out = q.new_empty((B, lq, F))
    rc = _f32_entry(qp, kp, vp, ld, out.data_ptr(), B, lq, n_heads, None if stamps is None else stamps.data_ptr(),
                    _build.raw_stream(dev))
    if rc:
        _build.check(_lib(), rc, "attention_middle_f32")
    attention_middle_f32.launches += 1
    return out


def attn_f32_stamps(q, k, v, n_heads: int) -> torch.Tensor:
    """One launch of the f32 mode that records the card's clock in thread 0
    of each CTA: (grid CTAs, ``F32_STAMPS``) int64, the cycles until Q and
    K landed and K was split, of the scores, of the softmax, of V's split
    with PV and the store, of the CTA's whole run, and the whole run in ns
    (``%globaltimer``). A CTA's warp 0 always holds query rows, so every
    phase is timed."""
    plan = attn_f32_plan(*q.shape[:2], n_heads)
    stamps = torch.zeros(plan["grid"], F32_STAMPS, dtype=torch.int64, device=q.device)
    _launch_f32(q, k, v, n_heads, stamps)
    return stamps


def attn_work(B: int, lq: int, F: int, dtype=torch.bfloat16):
    """(flops, bytes) of one call: q k^T and P v, each 2 * B * lq * lq * F
    operations over all heads; q, k, v read once, out written once, in
    ``dtype``."""
    return 2 * 2 * B * lq * lq * F, 4 * B * lq * F * torch.finfo(dtype).bits // 8
