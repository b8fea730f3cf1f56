"""K7, the training FFN block of a decoder layer: a hand-written CUDA
forward and backward (``csrc/ffn_train.cu``), their plain PyTorch
versions, and the ``torch.autograd.Function`` that binds them.

Replaces ``msmd_tpu/ops/pallas/ffn_train_kernel.py::fused_ffn_ln_train``:

    out = LN(x + drop2(drop1(gelu(x W1 + b1)) W2 + b2))

with inverted-dropout masks made inside the kernels, and a backward that
recomputes the forward from x with the same masks: the Function saves x,
the weights and the seed, never the hidden state or a mask. Weights are
in the ``nn.Linear`` layout (w1 (FFN, F), w2 (F, FFN)); the JAX kernel
takes their transposes. Both versions round where the JAX kernel rounds
(``ffn_train_kernel.py``:107-219): each product's left operand is cast to
the weights' dtype and summed in f32, biases are added in f32, GELU is the
erf form with the Abramowitz & Stegun erf of ``decoder_kernel.py::_erf``,
the residual and LayerNorm are f32, out and dx take x's dtype and the
parameter gradients their parameter's.

Masks. The kernels make Philox masks: the bits of (row, col) are
``Philox4x32-10(key=(seed, salt), counter=(col // 4, row, 0, 0))[col % 4]``,
salt 1 for the hidden state and 2 for the FFN output, kept where
``bits >= uint32(p * 2**32)`` and scaled by ``1 / (1 - p)``. The plain
version makes the same masks by default (``masks="philox"``); its
``masks="jax"``, for the CPU parity tests only, gives the bits of the JAX
kernel's interpret mode, the iota hash ``_det_bits`` with its per-tile
offset, which is a lattice, not random bits, and is not used for training.

Routes (``ffn_train_plan``, mirrored by the library's
``msmd_ffn_train_plan``), chosen by shape: from ``MIN_ROWS`` rows with F =
512 and FFN a multiple of 256, the warp-specialized wgmma GEMM of
``csrc/gemm_train.cuh`` (the forward 2 launches, the backward 6, the
LayerNorm products and dx as clusters of two column halves x two K-slices,
the weight gradients as clusters of two K-slices (row chunks), the column
sums of the bias and LayerNorm gradients by a last pass); every other
shape the wmma chain of the first version (3 and 15 launches). The
LayerNorm of the wgmma route combines two 256-column halves
(``ln_backward_pair_plain`` is its plain twin).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.gemm import MIN_ROWS

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# ---------------------------------------------------------------------------
# dropout bits
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, b: int):
    """(hi, lo) 32-bit halves of a * b for a in [0, 2**32) (int64) and a
    32-bit constant b, without overflowing int64."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p1, p2 = a * b_lo, a * b_hi  # each < 2**48
    s = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (s >> 32), s & _M32


def philox4x32_10(key0, key1: int, c0, c1, c2, c3):
    """Philox4x32 with 10 rounds on int64 tensors holding 32-bit values."""
    k0, k1 = key0, key1
    for i in range(10):
        if i > 0:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mul32(c0, _PHILOX_M[0])
        hi1, lo1 = _mul32(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_int64(seed, device) -> torch.Tensor:
    return (torch.as_tensor(seed, device=device).reshape(()).to(torch.int64)) & _M32


def philox_bits(seed, salt: int, rows: int, cols: int, device=None) -> torch.Tensor:
    """(rows, cols) int64 mask bits of the kernels' generator; cols % 4 == 0."""
    if cols % 4:
        raise ValueError(f"philox_bits: cols must be a multiple of 4, got {cols}")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    row = torch.arange(rows, dtype=torch.int64, device=dev)[:, None].expand(rows, cols // 4)
    grp = torch.arange(cols // 4, dtype=torch.int64, device=dev)[None, :].expand(rows, cols // 4)
    zero = torch.zeros_like(row)
    out = philox4x32_10(_seed_int64(seed, dev), salt, grp, row, zero, zero)
    return torch.stack(out, dim=-1).reshape(rows, cols)


def pick_tile(rows: int, target: int = 512) -> int:
    """The JAX kernels' row tile (``msmd_tpu/ops/pallas/ffn_kernel.py::_pick_tile``):
    the largest multiple of 16 up to ``target`` that divides ``rows``,
    else all rows."""
    if rows <= target:
        return rows
    best = 0
    for d in range(16, target + 1, 16):
        if rows % d == 0:
            best = d
    return best or rows


def jax_interpret_bits(seed, salt: int, rows: int, cols: int, device=None) -> torch.Tensor:
    """(rows, cols) int64 bits of the JAX kernel's interpret mode: the iota
    hash ``_det_bits`` over each row tile, offset by
    ``seed * 2946901 + 83492791 * tile`` (``ffn_train_kernel.py``:81-89, 120-122)."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    tile = pick_tile(rows)
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    off = (_mul32(_seed_int64(seed, dev), 2946901)[1] + 83492791 * (r // tile)) & _M32
    h = ((r % tile) * 2654435761 + c * 40503 + salt * 97 + off) & _M32
    h = _mul32(h, 2246822519)[1]
    return h ^ (h >> 13)


def _threshold(p: float) -> int:
    return int(p * 2.0 ** 32)  # P(bits < thr) = p


def _scale(p: float) -> float:
    return float(np.float32(1.0) / np.float32(1.0 - p))


def keep_mask(bits: torch.Tensor, p: float) -> torch.Tensor:
    """Inverted-dropout multipliers (0 or 1 / (1 - p)) in f32."""
    return (bits >= _threshold(p)).to(torch.float32) / np.float32(1.0 - p)


def _masks(kind: str, seed, rows: int, F: int, FF: int, p: float, device):
    bits = {"philox": philox_bits, "jax": jax_interpret_bits}.get(kind)
    if bits is None:
        raise ValueError(f"unknown mask kind {kind!r}")
    return keep_mask(bits(seed, 1, rows, FF, device), p), keep_mask(bits(seed, 2, rows, F, device), p)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

_INV_SQRT_2 = np.float32(1.0 / np.sqrt(2.0))
_INV_SQRT_2PI = np.float32(1.0 / np.sqrt(2.0 * np.pi))


def _erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26, |err| <= 1.5e-7 (the JAX kernels' erf)."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_erf(u: torch.Tensor) -> torch.Tensor:
    return u * 0.5 * (1.0 + _erf(u * _INV_SQRT_2))


def gelu_erf_grad(u: torch.Tensor) -> torch.Tensor:
    phi = _INV_SQRT_2PI * torch.exp(-0.5 * u * u)
    return 0.5 * (1.0 + _erf(u * _INV_SQRT_2)) + u * phi


def _recompute(x, w1, b1, w2, b2, seed, p, masks):
    """The forward chain to the residual sum: (x2d f32, u, m1, h, m2, r)."""
    F, FF = x.shape[-1], w1.shape[0]
    rnd = lambda a: a.to(w1.dtype).float()
    x2 = x.reshape(-1, F)
    m1 = m2 = None
    if p > 0.0:
        m1, m2 = _masks(masks, seed, x2.shape[0], F, FF, p, x.device)
    u = rnd(x2) @ w1.float().t() + b1.float()
    h = gelu_erf(u)
    if m1 is not None:
        h = h * m1
    y = rnd(h) @ w2.float().t() + b2.float()
    if m2 is not None:
        y = y * m2
    return x2.float(), u, m1, h, m2, x2.float() + y


def ffn_train_forward_plain(x, w1, b1, w2, b2, g, b, seed, p: float, masks: str = "philox") -> torch.Tensor:
    """K7's forward in plain PyTorch. x (..., F) -> out (..., F) in x's dtype."""
    *_, r = _recompute(x, w1, b1, w2, b2, seed, p, masks)
    mu = r.mean(dim=-1, keepdim=True)
    var = (r - mu).square().mean(dim=-1, keepdim=True)
    out = (r - mu) * torch.rsqrt(var + 1e-5) * g.float() + b.float()
    return out.to(x.dtype).reshape(x.shape)


def ffn_train_backward_plain(x, gbar, w1, b1, w2, b2, g, b, seed, p: float, masks: str = "philox"):
    """K7's backward in plain PyTorch, by recomputation from x with the same
    masks (``ffn_train_kernel.py``:161-219). Returns (dx, dw1, db1, dw2,
    db2, dg, db) in the dtypes of (x, w1, b1, w2, b2, g, b)."""
    x2, u, m1, h, m2, r = _recompute(x, w1, b1, w2, b2, seed, p, masks)
    gb = gbar.reshape(x2.shape).float()
    mu = r.mean(dim=-1, keepdim=True)
    var = (r - mu).square().mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(var + 1e-5)
    yh = (r - mu) * rs
    dyh = gb * g.float()
    dr = rs * (dyh - dyh.mean(dim=-1, keepdim=True) - yh * (dyh * yh).mean(dim=-1, keepdim=True))
    return _grads(x, x2, gb, yh, dr, u, m1, h, m2, w1, b1, w2, b2, g, b)


def _grads(x, x2, gb, yh, dr, u, m1, h, m2, w1, b1, w2, b2, g, b):
    """The seven gradients from the LayerNorm's (yhat, dr) and the
    recomputed forward."""
    rnd = lambda a: a.to(w1.dtype).float()
    dy = dr * m2 if m2 is not None else dr
    dh = rnd(dy) @ w2.float()
    dgl = dh * m1 if m1 is not None else dh
    du = dgl * gelu_erf_grad(u)
    dx = dr + rnd(du) @ w1.float()
    return (
        dx.to(x.dtype).reshape(x.shape),
        (rnd(du).t() @ rnd(x2)).to(w1.dtype),
        du.sum(dim=0).to(b1.dtype),
        (rnd(dy).t() @ rnd(h)).to(w2.dtype),
        dy.sum(dim=0).to(b2.dtype),
        (gb * yh).sum(dim=0).to(g.dtype),
        gb.sum(dim=0).to(b.dtype),
    )


def ln_backward_pair_plain(r, gbar, gamma):
    """The LayerNorm backward of K7's wgmma route (``gemm_train.cuh``,
    ``tr_epilogue_ln``) in plain PyTorch: (yhat, dr) of rows r (n, F) whose
    two F / 2-column halves lie in two CTAs. Each half gives its sum and its
    sum of squared deviations from its own mean, combined as Chan et al.'s
    pairwise update (``ws_row_stats``); then each half's sums of dyhat =
    gbar gamma and of dyhat yhat, added across the halves."""
    F = r.shape[-1]
    n = F // 2
    halves = (r[:, :n], r[:, n:])
    s = [t.sum(dim=-1) for t in halves]
    sq = [(t - si[:, None] / n).square().sum(dim=-1) for t, si in zip(halves, s)]
    delta = s[1] / n - s[0] / n
    m2 = (sq[0] + sq[1]) + delta * delta * (0.25 * F)
    mean, rs = (s[0] + s[1]) / F, torch.rsqrt(m2 / F + 1e-5)
    yh = (r - mean[:, None]) * rs[:, None]
    dyh = gbar * gamma
    a = dyh[:, :n].sum(dim=-1) + dyh[:, n:].sum(dim=-1)
    by = (dyh * yh)[:, :n].sum(dim=-1) + (dyh * yh)[:, n:].sum(dim=-1)
    return yh, rs[:, None] * (dyh - (a / F)[:, None] - yh * (by / F)[:, None])


def ffn_train_backward_pair_plain(x, gbar, w1, b1, w2, b2, g, b, seed, p: float, masks: str = "philox"):
    """``ffn_train_backward_plain`` with the LayerNorm backward of the
    wgmma route (``ln_backward_pair_plain``) in place of the whole-row one."""
    x2, u, m1, h, m2, r = _recompute(x, w1, b1, w2, b2, seed, p, masks)
    gb = gbar.reshape(x2.shape).float()
    yh, dr = ln_backward_pair_plain(r, gb, g.float())
    return _grads(x, x2, gb, yh, dr, u, m1, h, m2, w1, b1, w2, b2, g, b)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

TILE_M, TILE_N, TILE_K = 128, 256, 64  # gemm_train.cuh: WS_BM, WS_BN, WS_BK
CLUSTER = 4  # tr_cluster of the N = 512 products: two column halves x two K-slices
WGRAD_CLUSTER = 2  # tr_cluster of the weight gradients: two K-slices


def takes_wgmma(R: int, F: int, FF: int) -> bool:
    """Whether K7 runs on the wgmma GEMM at this shape (``ffn_wgmma_ok``)."""
    return R >= MIN_ROWS and F == 2 * TILE_N and FF > 0 and FF % TILE_N == 0


def k_halves(K: int):
    """The two K-slices of a split product: the first and the second half of
    K's 64-deep k-steps, the first the larger (gemm_train_kernel's kb, ke),
    as ranges of K."""
    steps = -(-K // TILE_K)
    h = -(-steps // 2) * TILE_K
    return [(0, min(K, h)), (h, K)]


def _product(M: int, N: int, K: int, epilogue: str, splits) -> dict:
    """A product's output tiles (m0, n0), each with the K ranges summed into
    it in order; ``splits`` the ranges of K."""
    tiles = [(m0, n0) for m0 in range(0, M, TILE_M) for n0 in range(0, N, TILE_N)]
    return {"M": M, "N": N, "K": K, "epilogue": epilogue, "tile": (TILE_M, TILE_N),
            "tiles": [{"m0": m0, "n0": n0, "k": list(splits)} for m0, n0 in tiles]}


def ffn_train_plan(R: int, F: int, FF: int, backward: bool) -> dict:
    """What K7's forward (``backward`` False) or backward runs at R rows:
    ``route`` "wgmma" or "wmma", ``launches``, the weight gradients'
    ``row_chunks`` (0 where none) and, on the wgmma route, ``grids`` (the
    CTAs of each launch in order) and ``products`` (each product's tiles and
    the K ranges summed into each, in order). Raises for a shape neither
    route takes."""
    if R < 1 or F % 128 or FF % 128 or F > 1024:
        raise ValueError(f"ffn_train: R={R}, F={F}, FFN={FF}: needs R >= 1, F and FFN multiples of 128, F <= 1024")
    if not takes_wgmma(R, F, FF):
        return {"route": "wmma", "launches": 15 if backward else 3, "row_chunks": 0, "grids": [], "products": {}}
    rb = -(-R // TILE_M)
    wide, pairs = rb * (FF // TILE_N), CLUSTER * rb
    halves = k_halves(FF)
    products = {
        "ffn1": dict(_product(R, FF, F, "hidden_grad" if backward else "hidden", [(0, F)]), cluster=1),
        "ffn2": dict(_product(R, F, FF, "layernorm_backward" if backward else "layernorm", halves), cluster=CLUSTER),
    }
    if not backward:
        return {"route": "wgmma", "launches": 2, "row_chunks": 0, "grids": [wide, pairs], "products": products}
    rows = k_halves(R)
    products.update(
        dh=dict(_product(R, FF, F, "du", [(0, F)]), cluster=1),
        dx=dict(_product(R, F, FF, "dx", halves), cluster=CLUSTER),
        dw1=dict(_product(FF, F, R, "wgrad", rows), cluster=WGRAD_CLUSTER),
        dw2=dict(_product(F, FF, R, "wgrad", rows), cluster=WGRAD_CLUSTER),
    )
    wgrad = WGRAD_CLUSTER * 2 * (FF // TILE_M) * (F // TILE_N)
    grids = [wide, pairs, wide, pairs, wgrad, (FF + 3 * F) // 32]  # the last: 32 columns of db1, db2, dg, db a block
    return {"route": "wgmma", "launches": 6, "row_chunks": WGRAD_CLUSTER, "grids": grids, "products": products}


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("ffn_train")
    if not getattr(lib, "_msmd_typed", False):
        vp, ci, cu, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.msmd_ffn_train_workspace_bytes.argtypes = [ci] * 4
        lib.msmd_ffn_train_workspace_bytes.restype = ctypes.c_size_t
        lib.msmd_ffn_train_forward.argtypes = [vp] * 8 + [cu, cf] + [vp] * 2 + [ci] * 3 + [vp]
        lib.msmd_ffn_train_forward.restype = ci
        lib.msmd_ffn_train_backward.argtypes = [vp] * 9 + [cu, cf] + [vp] * 8 + [ci] * 3 + [vp]
        lib.msmd_ffn_train_backward.restype = ci
        lib.msmd_ffn_train_mask_bits.argtypes = [vp, ci, ci, ci, vp, vp]
        lib.msmd_ffn_train_mask_bits.restype = ci
        lib.msmd_ffn_train_plan.argtypes = [ci] * 4 + [ctypes.POINTER(ctypes.c_long)]
        lib.msmd_ffn_train_plan.restype = None
        lib._msmd_typed = True
    return lib


def kernel_plan(R: int, F: int, FF: int, backward: bool) -> Optional[dict]:
    """``msmd_ffn_train_plan`` as the library computes it on the current
    card: ``ffn_train_plan``'s route, launches, row_chunks and grids (None
    where neither route takes the shape)."""
    out = (ctypes.c_long * 9)()
    _lib().msmd_ffn_train_plan(R, F, FF, int(backward), out)
    if out[0] < 0:
        return None
    return {"route": "wgmma" if out[0] == 1 else "wmma", "launches": out[1], "row_chunks": out[2],
            "grids": [g for g in out[3:] if g > 0]}


def _check(name, x, w1, b1, w2, b2, g, b, seed, gbar=None):
    F, FF = x.shape[-1], w1.shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    extra = {} if gbar is None else {"gbar": (gbar, x.shape, bf)}
    _build.check_args(name, x.device, x=(x, x.shape, bf), w1=(w1, (FF, F), bf), b1=(b1, (FF,), bf),
                      w2=(w2, (F, FF), bf), b2=(b2, (F,), bf), g=(g, (F,), f32), b=(b, (F,), f32),
                      seed=(seed, (1,), torch.int32), **extra)
    if F % 128 or FF % 128 or F > 1024:
        raise ValueError(f"{name}: the kernel needs F and FFN multiples of 128 and F <= 1024 (F={F}, FFN={FF})")


def ffn_train_forward(x, w1, b1, w2, b2, g, b, seed, p: float) -> torch.Tensor:
    """K7 forward. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (bf16, seed a (1,) int32 tensor) or raises."""
    if _build.on_cpu("ffn_train_forward", x):
        return ffn_train_forward_plain(x, w1, b1, w2, b2, g, b, seed, p)
    _check("ffn_train_forward", x, w1, b1, w2, b2, g, b, seed)
    F, FF = x.shape[-1], w1.shape[0]
    R = x.numel() // F
    lib = _lib()
    out = torch.empty_like(x)
    ws = torch.empty(lib.msmd_ffn_train_workspace_bytes(R, F, FF, 0), dtype=torch.uint8, device=x.device)
    rc = lib.msmd_ffn_train_forward(*(_build.ptr(t) for t in (x, w1, b1, w2, b2, g, b, seed)), _threshold(p),
                                    _scale(p), _build.ptr(out), _build.ptr(ws), R, F, FF, _build.stream(x.device))
    _build.check(lib, rc, "ffn_train_forward")
    ffn_train_forward.launches += 1
    return out


ffn_train_forward.launches = 0


def ffn_train_backward(x, gbar, w1, b1, w2, b2, g, b, seed, p: float):
    """K7 backward: (dx, dw1, db1, dw2, db2, dg, db). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if _build.on_cpu("ffn_train_backward", x):
        return ffn_train_backward_plain(x, gbar, w1, b1, w2, b2, g, b, seed, p)
    _check("ffn_train_backward", x, w1, b1, w2, b2, g, b, seed, gbar=gbar)
    F, FF = x.shape[-1], w1.shape[0]
    R = x.numel() // F
    lib = _lib()
    grads = [torch.empty_like(t) for t in (x, w1, b1, w2, b2, g, b)]
    ws = torch.empty(lib.msmd_ffn_train_workspace_bytes(R, F, FF, 1), dtype=torch.uint8, device=x.device)
    rc = lib.msmd_ffn_train_backward(*(_build.ptr(t) for t in (x, gbar, w1, b1, w2, b2, g, b, seed)), _threshold(p),
                                     _scale(p), *(_build.ptr(t) for t in grads), _build.ptr(ws), R, F, FF, _build.stream(x.device))
    _build.check(lib, rc, "ffn_train_backward")
    ffn_train_backward.launches += 1
    return tuple(grads)


ffn_train_backward.launches = 0


def kernel_mask_bits(seed: torch.Tensor, salt: int, rows: int, cols: int) -> torch.Tensor:
    """The raw mask bits from the kernels' device generator, (rows, cols)
    int64, through the library's debug entry (CUDA only)."""
    if seed.device.type != "cuda":
        raise ValueError(f"kernel_mask_bits: unsupported device {seed.device}")
    lib = _lib()
    out = torch.empty(rows, cols, dtype=torch.int32, device=seed.device)
    rc = lib.msmd_ffn_train_mask_bits(_build.ptr(seed), salt, rows, cols, _build.ptr(out), _build.stream(seed.device))
    _build.check(lib, rc, "kernel_mask_bits")
    return out.to(torch.int64) & _M32


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FusedFFNLNTrain(torch.autograd.Function):
    """K7 with the recompute backward: saves x, the weights and the seed."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, g, b, seed, p):
        ctx.save_for_backward(x, w1, b1, w2, b2, g, b, seed)
        ctx.p = p
        return ffn_train_forward(x, w1, b1, w2, b2, g, b, seed, p)

    @staticmethod
    def backward(ctx, gbar):
        x, w1, b1, w2, b2, g, b, seed = ctx.saved_tensors
        grads = ffn_train_backward(x, gbar.contiguous(), w1, b1, w2, b2, g, b, seed, ctx.p)
        return (*grads, None, None)


def fused_ffn_ln_train(x, w1, b1, w2, b2, g, b, seed: torch.Tensor, p: float):
    """``LN(x + drop2(drop1(gelu(x w1^T + b1)) w2^T + b2))`` with in-kernel
    dropout at rate ``p`` and the recompute backward. ``seed``: a (1,)
    int32 tensor on x's device; vary it per layer call for fresh masks.
    Any row count (the leading dims of x) is taken."""
    return FusedFFNLNTrain.apply(x, w1, b1, w2, b2, g, b, seed, float(p))


def ffn_train_work(rows: int, F: int, FF: int, backward: bool):
    """(flops, bytes) of one forward or backward call at bf16 weights and
    f32 LayerNorm parameters: 2 or 6 products of 2 * rows * F * FF
    operations; each input read once, each output written once."""
    flops = (6 if backward else 2) * 2 * rows * F * FF
    weights = 2 * F * FF * 2 + (FF + F) * 2 + 2 * F * 4
    acts = rows * F * 2
    if backward:  # x, gbar in; dx, dw1, dw2, db1, db2, dg, db out
        nbytes = 2 * acts + weights + acts + 2 * F * FF * 2 + (FF + F) * 2 + 2 * F * 4
    else:  # x in; out
        nbytes = acts + weights + acts
    return flops, nbytes


def seed_tensor(seed: int, device) -> torch.Tensor:
    """A K7 seed as the kernels take it."""
    return torch.tensor([seed], dtype=torch.int32, device=device)

