"""K10, WavLM's gated relative-position self-attention: hand-written CUDA
kernels for Hopper (``csrc/relpos_attn.cu``: forward and backward) and
their plain PyTorch versions.

K10 replaces no TPU kernel: the JAX package has no WavLM. It was added
because no kernel of the port takes an additive bias (K8 and the
small-row stack take none), and neither does PyTorch's flash attention:
given a float mask, ``scaled_dot_product_attention`` falls back to a path
that writes the (B H, L, L) bias and its gradient in every layer.

Per entry b and head h, from projected q, k, v (B, L, H, 64) in bf16, the
gate g (B, H, L) and the head's table of offsets r (H, 2L - 1), both f32:

    S[i, j] = q_i . k_j / 8 + g[b, h, i] r[h, j - i + L - 1]
    out_i   = sum_j softmax_j(S[i, :]) v_j

Forward (``k10_relpos_fwd``): a CTA per (entry, head, 64 query rows)
walks the key tiles of 64 on mma.sync; the bias is formed in registers
from g and the head's row of r, staged in shared memory; the softmax is
online, in f32, and the rows' log-sum-exp is written for the backward.
Neither the bias nor the probabilities are written to memory.

Backward: ``k10_relpos_bwd_pre`` (delta_i = dout_i . out_i), then
``k10_relpos_bwd_dkdv`` (a CTA per key tile, walking the query tiles: dk,
dv), ``k10_relpos_bwd_dq`` (a CTA per query tile, walking the key tiles:
dq, ``dg[b,h,i] = sum_j dS_ij r[h, j - i + L - 1]`` and the CTA's row of
partial sums of ``dr[h, d] = sum_{b,i} g[b,h,i] dS_{i,i+d}``, summed along
the diagonals of an f32 scratch tile) and ``k10_relpos_bwd_dr`` (the
partial rows summed over entries and query tiles). P and dS are
recomputed in registers. No float atomics, and every sum in a fixed
order: two calls give the same bits.

What bounds it on an H100: at the head width of 64 and L = 200, the
bytes of q, k, v, out (and dout, dq, dk, dv) against HBM, not the tensor
cores (about 100 operations a byte, against the card's 295).

Rounding (both versions): S in f32 from the bf16 operands; softmax in
f32; P rounded to bf16 for the PV product (the kernel rounds the running,
unnormalised P, the plain version the normalised one), sums in f32; dS
rounded to bf16 for the dq and dk products; dg and dr from the f32 dS.

``relpos_kernel_takes`` is the gate: bf16, head width ``HEAD_DIM``, L up
to ``MAX_L``. The layers' entry, ``relpos_attention``, routes a longer
sequence on the card to ``relpos_attention_plain`` under autograd and
counts it (``msmd.k10.plain_calls``); it raises for another dtype or head
width on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.utils.profiling import count

HEAD_DIM = 64
MAX_L = 2048  # the longest sequence K10 takes (the dq pass stages rows of 2L - 1 and L + 64 floats)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def offsets(L: int, device=None) -> torch.Tensor:
    """(L, L) int64: the column of r that S[i, j] reads, j - i + L - 1."""
    pos = torch.arange(L, device=device)
    return pos[None, :] - pos[:, None] + (L - 1)


def bias_plain(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The gated bias (B, H, L, L) f32 that the kernel never writes."""
    L = g.shape[-1]
    return g.float()[..., None] * r.float()[:, offsets(L, r.device)]


def relpos_attention_fwd_plain(q, k, v, g, r) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's forward in plain PyTorch: (out (B, L, H, D) in q's dtype, the
    rows' log-sum-exp (B, H, L) f32)."""
    D = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * D ** -0.5 + bias_plain(g, r)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = p.to(q.dtype).float() @ vh
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse


def relpos_attention_plain(q, k, v, g, r) -> torch.Tensor:
    """K10 in plain PyTorch (its twin): q, k, v (B, L, H, D), g (B, H, L),
    r (H, 2L - 1) -> (B, L, H, D) in q's dtype; differentiable by autograd."""
    return relpos_attention_fwd_plain(q, k, v, g, r)[0]


def relpos_attention_bwd_plain(q, k, v, g, r, out, lse, dout):
    """K10's backward in plain PyTorch, from the forward's out and
    log-sum-exp: (dq, dk, dv in q's dtype, dg (B, H, L) f32, dr (H, 2L - 1)
    f32)."""
    B, L, H, D = q.shape
    sc = D ** -0.5
    qh, kh, vh, oh, doh = (t.transpose(1, 2).float() for t in (q, k, v, out, dout))
    rel = r.float()[:, offsets(L, r.device)]
    s = (qh @ kh.transpose(-1, -2)) * sc + g.float()[..., None] * rel
    p = torch.exp(s - lse[..., None])
    dv = p.transpose(-1, -2) @ doh
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * oh).sum(-1, keepdim=True))
    dq, dk = (ds @ kh) * sc, (ds.transpose(-1, -2) @ qh) * sc
    dg = (ds * rel).sum(-1)
    z = (g.float()[..., None] * ds).sum(0).reshape(H, L * L)
    dr = torch.zeros(H, 2 * L - 1, dtype=torch.float32, device=q.device).index_add_(
        1, offsets(L, q.device).reshape(-1), z)
    back = lambda t: t.transpose(1, 2).to(q.dtype).contiguous()
    return back(dq), back(dk), back(dv), dg, dr


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

PLAN_KEYS = ("tiles", "fwd_smem", "dkdv_smem", "dq_smem", "part_floats", "max_l", "threads")


def relpos_plan(B: int, L: int, H: int = 16) -> dict:
    """K10's launch facts at (B, L, H) (``csrc/relpos_attn.cu``,
    ``msmd_relpos_plan``): the 64-row tiles a head (the grid is heads x
    tiles for the forward, dkdv and dq kernels), each one's shared memory
    a CTA, the floats of the backward's partial dr rows (B H tiles rows of
    L + 64), the longest L, threads a CTA. Raises for a shape the kernels do
    not take."""
    if B < 1 or H < 1 or not 1 <= L <= MAX_L:
        raise ValueError(f"relpos_attention: B={B}, L={L}, H={H}: needs B, H >= 1 and 1 <= L <= {MAX_L}")
    tiles = -(-L // 64)
    r_floats = (2 * L - 1 + 128 + 3) // 4 * 4
    tile = 64 * 128
    return dict(tiles=tiles, fwd_smem=5 * tile + 4 * r_floats, dkdv_smem=6 * tile + 4 * (6 * 64 + r_floats),
                dq_smem=6 * tile + 4 * (64 * 72 + r_floats + L + 64), part_floats=B * H * tiles * (L + 64),
                max_l=MAX_L, threads=128)


def _lib():
    lib = _build.load("relpos_attn")
    if not getattr(lib, "_msmd_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmd_relpos_plan.argtypes = [ci] * 3 + [ctypes.POINTER(ctypes.c_long)]
        lib.msmd_relpos_plan.restype = ci
        lib.msmd_relpos_forward.argtypes = [vp] * 7 + [ci] * 3 + [vp]
        lib.msmd_relpos_forward.restype = ci
        lib.msmd_relpos_backward.argtypes = [vp] * 15 + [ci] * 3 + [vp]
        lib.msmd_relpos_backward.restype = ci
        lib._msmd_typed = True
    return lib


def relpos_plan_cuda(B: int, L: int, H: int = 16) -> dict:
    """``relpos_plan`` as the library reports it (the card tests hold the
    two equal)."""
    lib = _lib()
    out = (ctypes.c_long * len(PLAN_KEYS))()
    _build.check(lib, lib.msmd_relpos_plan(B, L, H, out), "relpos_plan")
    return dict(zip(PLAN_KEYS, out))


def relpos_work(B: int, L: int, H: int = 16, D: int = HEAD_DIM, backward: bool = False):
    """(flops, bytes) of one K10 call: the forward's two products, the
    backward's five (QK^T again, dP, dV, dQ, dK); q, k, v, out (and dout,
    dq, dk, dv) in bf16 and the gate, log-sum-exp (and dg) in f32, each
    read or written once (``h100bench/wavlm_work.py::k10_work``)."""
    rows = B * H * L
    flops = (5 if backward else 2) * 2 * rows * L * D
    return flops, (8 if backward else 4) * rows * D * 2 + (3 if backward else 2) * rows * 4


def relpos_kernel_takes(B: int, L: int, H: int, D: int, dtype) -> bool:
    """Whether K10 takes (B, L, H, D) in ``dtype`` on the card: bf16, head
    width ``HEAD_DIM``, 1 <= L <= ``MAX_L``."""
    return B >= 1 and H >= 1 and D == HEAD_DIM and 1 <= L <= MAX_L and dtype == torch.bfloat16


def _check(name: str, q, k, v, g, r) -> Tuple[int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, L, H, D), got {tuple(q.shape)}")
    B, L, H, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on the card; q is on {q.device}")
    if not relpos_kernel_takes(B, L, H, D, q.dtype):
        raise ValueError(f"{name}: the kernel takes bf16 q, k, v of head width {HEAD_DIM} and 1 <= L <= {MAX_L}; "
                         f"got {tuple(q.shape)} {q.dtype}")
    _build.check_args(name, q.device, k=(k, q.shape, torch.bfloat16), v=(v, q.shape, torch.bfloat16),
                      q=(q, q.shape, torch.bfloat16), g=(g, (B, H, L), torch.float32),
                      r=(r, (H, 2 * L - 1), torch.float32))
    return B, L, H


def relpos_attention_cuda(q, k, v, g, r) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's forward on the card: (out (B, L, H, 64) bf16, log-sum-exp
    (B, H, L) f32); one launch. Raises for what ``relpos_kernel_takes``
    refuses."""
    B, L, H = _check("relpos_attention", q, k, v, g, r)
    lib = _lib()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    p = _build.ptr
    rc = lib.msmd_relpos_forward(p(q), p(k), p(v), p(g), p(r), p(out), p(lse), B, L, H, _build.stream(q.device))
    _build.check(lib, rc, "relpos_attention")
    relpos_attention_cuda.launches += 1
    count("msmd.k10.calls")
    count("msmd.k10.fwd_rows", B * L)
    return out, lse


relpos_attention_cuda.launches = 0


def relpos_attention_bwd_cuda(q, k, v, g, r, out, lse, dout):
    """K10's backward on the card: (dq, dk, dv bf16, dg (B, H, L) f32, dr
    (H, 2L - 1) f32); four kernel launches, counted as one call."""
    B, L, H = _check("relpos_attention_bwd", q, k, v, g, r)
    _build.check_args("relpos_attention_bwd", q.device, out=(out, q.shape, torch.bfloat16),
                      dout=(dout, q.shape, torch.bfloat16), lse=(lse, (B, H, L), torch.float32))
    lib = _lib()
    dev = q.device
    delta = torch.empty(B, H, L, dtype=torch.float32, device=dev)
    part = torch.empty(relpos_plan(B, L, H)["part_floats"], dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dg = torch.empty(B, H, L, dtype=torch.float32, device=dev)
    dr = torch.empty(H, 2 * L - 1, dtype=torch.float32, device=dev)
    p = _build.ptr
    rc = lib.msmd_relpos_backward(p(q), p(k), p(v), p(g), p(r), p(out), p(lse), p(dout), p(delta), p(part), p(dq),
                                  p(dk), p(dv), p(dg), p(dr), B, L, H, _build.stream(dev))
    _build.check(lib, rc, "relpos_attention_bwd")
    relpos_attention_bwd_cuda.launches += 1
    count("msmd.k10.calls")
    count("msmd.k10.bwd_rows", B * L)
    return dq, dk, dv, dg, dr


relpos_attention_bwd_cuda.launches = 0


class RelposAttention(torch.autograd.Function):
    """(q, k, v, g, r) -> out: K10's forward on the card
    (``relpos_attention_fwd_plain`` on the CPU), its backward kernels (or
    ``relpos_attention_bwd_plain``) as the VJP."""

    @staticmethod
    def forward(ctx, q, k, v, g, r):
        if _build.on_cpu("relpos_attention", q):
            out, lse = relpos_attention_fwd_plain(q, k, v, g, r)
        else:
            out, lse = relpos_attention_cuda(q, k, v, g, r)
        ctx.save_for_backward(q, k, v, g, r, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, g, r, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if _build.on_cpu("relpos_attention_bwd", q):
            return relpos_attention_bwd_plain(q, k, v, g, r, out, lse, dout)
        return relpos_attention_bwd_cuda(q, k, v, g, r, out, lse, dout)


def relpos_attention(q, k, v, g, r) -> torch.Tensor:
    """The layers' entry: ``RelposAttention`` for CPU tensors and on the
    card up to ``MAX_L`` rows; on the card a longer sequence goes to
    ``relpos_attention_plain`` under autograd, counted as
    ``msmd.k10.plain_calls``. Raises on the card for anything but bf16 of
    head width ``HEAD_DIM``, which K10 never takes."""
    B, L, H, D = q.shape
    if q.device.type != "cpu":
        if q.dtype != torch.bfloat16 or D != HEAD_DIM:
            raise ValueError(f"relpos_attention: K10 takes bf16 q, k, v of head width {HEAD_DIM} on the card; "
                             f"got {tuple(q.shape)} {q.dtype}")
        if L > MAX_L:
            count("msmd.k10.plain_calls")
            return relpos_attention_plain(q, k, v, g, r)
    return RelposAttention.apply(q, k, v, g, r)
