"""The batch-1 DDPM sampler: hand-written CUDA kernels (``csrc/sampler.cu``)
for the whole 500-step window (K3) and for one step (K4), their plain
PyTorch versions, and the wrappers.

- ``fused_sampler_scan`` replaces ``msmd_tpu/ops/pallas/decoder_kernel.py::
  fused_sampler_scan`` (all T steps at batch 1, the motion carry in f32).
- ``fused_sampler_step`` replaces ``decoder_kernel.py::fused_sampler_step``
  (one step; the sampler takes it for trajectories).

A step builds the token rows, runs the decoder stack, decodes the tail
rows to motion, mixes the CFG entries and applies
``m <- A m + B target + sigma z``. Both run it as the phases of one
cooperative launch of the persistent small-row stack
(``csrc/decoder_small.cuh``; the plans in ``ops/kernels/small_stack.py``):
K3 one launch a window, K4 one launch a step (mode "entry_gather": its
gathered rows' cross product over every row). The two kernels round where
their TPU kernels round (see ``csrc/sampler.cu``): K3 keeps the prologue rows and
the cross output in f32 and adds the f32 hoisted ``vmw``; K4 rounds the
person and motion rows to bf16 and projects [bf16(person output) | memory
V rows] through ``wco`` on every row. At f32 (the plain versions only) the
softmax subtracts the max and GELU is erf, as in ``_attn_pv``/``_gelu``.

Layouts are the JAX package's. ``const`` holds ``prev_rows`` (P, Din),
``ind_col`` (N, 1), ``wfp`` (Din, F), ``bfp`` (1, F), ``persons_pre``
(E, F), ``pe_flat`` (E*lq, F), ``wd1`` (F, Fd), ``bd1`` (1, Fd), ``wd2``
(Fd, D+K), ``bd2`` (1, D+K), ``statics_rows`` (K, E*N, D),
``pose_sum_rows`` (E*N, 3), and for K3 the f32 ``vmw`` (L, E*lq, F). The
port keeps the rows unpadded (lq = 1 + P + N): the kernels mask the
ragged edge of the self-attention themselves, which is what the TPU
kernel's pad rows and key mask compute, so the selector and mask arrays
of the JAX ``const`` are not read.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _PACK_KEYS, decoder_layers_plain, gelu_tanh

_CONST_KEYS = ("prev_rows", "ind_col", "wfp", "bfp", "persons_pre", "pe_flat",
               "wd1", "bd1", "wd2", "bd2", "statics_rows", "pose_sum_rows")
_BF16_CONST = ("wfp", "wd1", "wd2")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _step_plain(pack, kmem, vmem, m, emb_row, sc, z, const, n_heads, n_entries, n_cur, d_motion,
                num_basis, use_indicator, sigmoid_alpha, coefficients, k4: bool) -> torch.Tensor:
    """One sampler step with K3's (``k4`` False) or K4's rounding points."""
    E, N, D, K = n_entries, n_cur, d_motion, num_basis
    cdt = pack["wqkv"].dtype
    fast = cdt == torch.bfloat16
    rnd = lambda a: a.to(cdt).float()
    dot = lambda a, w: rnd(a) @ w.float()
    F = pack["wso"].shape[-1]
    lq = const["pe_flat"].shape[0] // E
    P = const["prev_rows"].shape[0]

    # prologue: the token rows
    cur = torch.cat([m, const["ind_col"].float()], dim=1) if use_indicator else m
    rows = torch.cat([const["prev_rows"].float(), cur], dim=0)  # (lm, Din)
    feats = dot(rows, const["wfp"]) + const["bfp"].float()  # (lm, F)
    persons = const["persons_pre"].float() + emb_row.float().reshape(1, F)  # (E, F)
    if k4:  # K4 places them with one-hot selector products, which round to bf16
        persons, feats = rnd(persons), rnd(feats)
    x = torch.cat([persons[:, None], feats[None].expand(E, -1, -1)], dim=1)  # (E, lq, F)
    x = x + const["pe_flat"].float().reshape(E, lq, F)

    x = decoder_layers_plain(pack, kmem, vmem, x, torch.arange(E, device=x.device) * lq, n_heads,
                             None if k4 else const["vmw"], cross="gather" if k4 else "f32")

    # epilogue: motion decoder, style-basis combine, CFG mix, DDPM update
    tail = x[:, 1 + P:1 + P + N].reshape(E * N, F)
    h = dot(tail, const["wd1"]) + const["bd1"].float()
    h = gelu_tanh(h) if fast else torch.nn.functional.gelu(h)
    dec = dot(h, const["wd2"]) + const["bd2"].float()  # (E*N, D+K)
    dynamic, alphas = dec[:, :D], dec[:, D:D + K]
    if sigmoid_alpha:
        alphas = torch.sigmoid(alphas)
    statics = const["statics_rows"].float()
    face = dynamic[:, :D - 3]
    for kb in range(K):
        face = face + alphas[:, kb:kb + 1] * statics[kb, :, :D - 3]
    pose = dynamic[:, D - 3:] + const["pose_sum_rows"].float()
    out = torch.cat([face, pose], dim=1)
    target = torch.zeros(N, D, dtype=torch.float32, device=x.device)
    for e in range(E):
        target = target + float(coefficients[e]) * out[e * N:(e + 1) * N]
    sc = sc.float().reshape(-1)
    return sc[0] * m + sc[1] * target + sc[2] * z.float().reshape(N, D)


def fused_sampler_scan_plain(pack, kmem, vmem, motion_T, emb_scan, sc_scan, z_scan, const, n_heads: int,
                             n_entries: int, n_cur: int, d_motion: int, num_basis: int, use_indicator: bool,
                             sigmoid_alpha: bool, coefficients: Sequence[float]) -> torch.Tensor:
    """K3 in plain PyTorch: T steps with the f32 carry. motion_T (N, D),
    emb_scan (T, 1, F), sc_scan (T, 1, 8), z_scan (T, N, D) -> (N, D) f32."""
    m = motion_T.float()
    for s in range(z_scan.shape[0]):
        m = _step_plain(pack, kmem, vmem, m, emb_scan[s], sc_scan[s], z_scan[s], const, n_heads, n_entries,
                        n_cur, d_motion, num_basis, use_indicator, sigmoid_alpha, coefficients, k4=False)
    return m


def fused_sampler_step_plain(pack, kmem, vmem, motion_t, emb_row, sc, z, const, n_heads: int,
                             n_entries: int, n_cur: int, d_motion: int, num_basis: int, use_indicator: bool,
                             sigmoid_alpha: bool, coefficients: Sequence[float]) -> torch.Tensor:
    """K4 in plain PyTorch: one step. motion_t (N, D), emb_row (1, F),
    sc (1, 8), z (N, D) -> (N, D) f32."""
    return _step_plain(pack, kmem, vmem, motion_t.float(), emb_row, sc, z, const, n_heads, n_entries, n_cur,
                       d_motion, num_basis, use_indicator, sigmoid_alpha, coefficients, k4=True)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("sampler")
    if not getattr(lib, "_msmd_typed", False):
        for fn in (lib.msmd_sampler_scan, lib.msmd_sampler_step):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.msmd_sampler_workspace_bytes.argtypes = [ctypes.c_void_p]
        lib.msmd_sampler_workspace_bytes.restype = ctypes.c_size_t
        for fn in (lib.msmd_scan_plan, lib.msmd_step_plan):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.msmd_sampler_n_ptrs.restype = ctypes.c_int
        lib.msmd_sampler_n_dims.restype = ctypes.c_int
        lib._msmd_typed = True
    return lib


def _dims(lib, E, lq, F, H, L, FF, N, D, K, Fd, use_indicator, sigmoid_alpha, T, grid_blocks=0):
    # grid_blocks: the cooperative grid (0: every block the card holds at
    # once; more is refused)
    dims = [E, lq, F, H, L, FF, N, D, K, Fd, int(use_indicator), int(sigmoid_alpha), T, grid_blocks]
    if len(dims) != lib.msmd_sampler_n_dims():
        raise RuntimeError("csrc/sampler.cu and its wrapper disagree on the size list")
    return (ctypes.c_int * len(dims))(*dims)


def scan_plan(lq: int, F: int, H: int, L: int, FF: int, n_cur: int, d_motion: int, num_basis: int, Fd: int,
              use_indicator: bool = True, n_entries: int = 2, step: bool = False) -> dict:
    """K3's plan (``step``: K4's) on the current card (``msmd_scan_plan``,
    ``msmd_step_plan``) as ``small_stack.c_plan_rows`` gives it: grid,
    blocks per SM, shared memory and the (kind, items, M, N, K, bm, split)
    of each phase of a step."""
    from msmd_tpu_torch.ops.kernels.small_stack import c_plan_rows

    lib = _lib()
    c_dims = _dims(lib, n_entries, lq, F, H, L, FF, n_cur, d_motion, num_basis, Fd, use_indicator, False, 1)
    out = (ctypes.c_long * (4 + 7 * (3 + 11 * L)))()
    entry = lib.msmd_step_plan if step else lib.msmd_scan_plan
    _build.check(lib, entry(c_dims, out), "msmd_step_plan" if step else "msmd_scan_plan")
    return c_plan_rows(out)


def scan_stamps(T: int, L: int) -> int:
    """The card-clock stamps K3 writes for a T-step window (K4 for its one
    step, T = 1): one at the launch's start, one after its token rows and
    11 L + 2 per step."""
    return 2 + T * (11 * L + 2)


def _check_inputs(what, pack, kmem, vmem, motion, emb, sc, z, const, n_heads, n_entries, n_cur, d_motion,
                  num_basis, use_indicator, coefficients, T):
    E, N, D, K = n_entries, n_cur, d_motion, num_basis
    L, F = pack["wqkv"].shape[0], pack["wso"].shape[-1]
    FF, Fd = pack["wf1"].shape[-1], const["wd1"].shape[-1]
    lq = const["pe_flat"].shape[0] // E
    lm, P = lq - 1, lq - 1 - N
    Din = D + int(use_indicator)
    want = {
        "wqkv": (L, F, 3 * F), "bqkv": (L, 1, 3 * F), "wso": (L, F, F), "bso": (L, 1, F),
        "wcq": (L, F, F), "bcq": (L, 1, F), "wco": (L, F, F), "bco": (L, 1, F),
        "wf1": (L, F, FF), "bf1": (L, 1, FF), "wf2": (L, FF, F), "bf2": (L, 1, F),
        "ln_scale": (L, 3, F), "ln_bias": (L, 3, F),
        "kmem": (L, E * lm, F), "vmem": (L, E * lm, F),
        "prev_rows": (P, Din), "ind_col": (N, 1), "wfp": (Din, F), "bfp": (1, F), "persons_pre": (E, F),
        "pe_flat": (E * lq, F), "wd1": (F, Fd), "bd1": (1, Fd), "wd2": (Fd, D + K), "bd2": (1, D + K),
        "statics_rows": (K, E * N, D), "pose_sum_rows": (E * N, 3),
        "motion": (N, D), "emb": (T, 1, F) if what == "fused_sampler_scan" else (1, F),
        "sc": (T, 1, 8) if what == "fused_sampler_scan" else (1, 8),
        "z": (T, N, D) if what == "fused_sampler_scan" else (N, D),
    }
    named = {k: pack[k] for k in _PACK_KEYS}
    named.update({k: const[k] for k in _CONST_KEYS})
    named.update(kmem=kmem, vmem=vmem, motion=motion, emb=emb, sc=sc, z=z)
    if what == "fused_sampler_scan":
        want["vmw"] = (L, E * lq, F)
        named["vmw"] = const["vmw"]
    for name, t in named.items():
        bf = name in _BF16_CONST or name in ("kmem", "vmem") or (name in _PACK_KEYS and not name.startswith("ln"))
        dtype = torch.bfloat16 if bf else torch.float32
        if t.device.type != "cuda" or t.device != motion.device:
            raise ValueError(f"{what}: {name} must be on {motion.device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if F // n_heads != 64 or F % n_heads or F % 128 or FF % 128 or Fd % 128:
        raise ValueError(f"{what}: kernel needs head dim 64 and F, FFN, motion-decoder width multiples of 128 "
                         f"(F={F}, H={n_heads}, FFN={FF}, Fd={Fd})")
    if not 2 <= lq <= 128 or P < 0 or D < 3:
        raise ValueError(f"{what}: kernel needs 2 <= lq <= 128, P >= 0 and D >= 3 (lq={lq}, P={P}, D={D})")
    if len(coefficients) != E:
        raise ValueError(f"{what}: {len(coefficients)} CFG coefficients for {E} entries")
    if T < 1:
        raise ValueError(f"{what}: needs at least one step")


@functools.lru_cache(maxsize=32)
def _index_tables(dev: torch.device, E: int, lq: int, N: int, coefficients: tuple):
    """The CFG coefficients (E,) f32, the person rows e*lq and the tail rows
    e*lq + 1 + P + i (int32) on ``dev``, made once per shape: a tensor made
    from host data is a copy that waits for the card, which K4's wrapper
    would otherwise pay at every step."""
    coef = torch.tensor(coefficients, dtype=torch.float32, device=dev)
    rows = (torch.arange(E, dtype=torch.int32, device=dev) * lq).contiguous()
    tail = (rows[:, None] + lq - N + torch.arange(N, dtype=torch.int32, device=dev)).reshape(-1).contiguous()
    return coef, rows, tail


def _launch(entry, pack, kmem, vmem, motion, emb, sc, z, const, n_heads, n_entries, n_cur, d_motion,
            num_basis, use_indicator, sigmoid_alpha, coefficients, T, stamps=None, _grid_blocks=0):
    E, N = n_entries, n_cur
    dev = motion.device
    lib = _lib()
    lq = const["pe_flat"].shape[0] // E
    c_dims = _dims(lib, E, lq, pack["wso"].shape[-1], n_heads, pack["wqkv"].shape[0], pack["wf1"].shape[-1], N,
                   d_motion, num_basis, const["wd1"].shape[-1], use_indicator, sigmoid_alpha, T, _grid_blocks)
    ws_bytes = lib.msmd_sampler_workspace_bytes(c_dims)
    out = torch.empty_like(motion)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    coef, rows, tail = _index_tables(dev, E, lq, N, tuple(float(c) for c in coefficients))
    vmw = const["vmw"] if entry == "msmd_sampler_scan" else None
    tensors = ([pack[k] for k in _PACK_KEYS] + [kmem, vmem, vmw] + [const[k] for k in _CONST_KEYS]
               + [coef, emb, sc, z, motion, out, ws, rows, tail, stamps])
    if len(tensors) != lib.msmd_sampler_n_ptrs():
        raise RuntimeError("csrc/sampler.cu and its wrapper disagree on the pointer list")
    c_ptrs = (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])
    rc = getattr(lib, entry)(c_ptrs, c_dims, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, rc, entry)
    return out


def sampler_scan_stamps(pack, kmem, vmem, motion_T, emb_scan, sc_scan, z_scan, const, n_heads, n_entries, n_cur,
                        d_motion, num_basis, use_indicator, sigmoid_alpha, coefficients) -> torch.Tensor:
    """One K3 window with the card's clock (ns, int64) recorded by block 0
    at the start of the launch and after every phase (``scan_stamps``);
    for the per-phase split of ``python -m msmd_tpu_torch.profile``. Not
    counted as a launch of the main path."""
    T, L = z_scan.shape[0], pack["wqkv"].shape[0]
    _check_inputs("fused_sampler_scan", pack, kmem, vmem, motion_T, emb_scan, sc_scan, z_scan, const, n_heads,
                  n_entries, n_cur, d_motion, num_basis, use_indicator, coefficients, T)
    stamps = torch.zeros(scan_stamps(T, L), dtype=torch.int64, device=motion_T.device)
    _launch("msmd_sampler_scan", pack, kmem, vmem, motion_T, emb_scan, sc_scan, z_scan, const, n_heads, n_entries,
            n_cur, d_motion, num_basis, use_indicator, sigmoid_alpha, coefficients, T, stamps=stamps)
    return stamps


def sampler_step_stamps(pack, kmem, vmem, motion_t, emb_row, sc, z, const, n_heads, n_entries, n_cur, d_motion,
                        num_basis, use_indicator, sigmoid_alpha, coefficients) -> torch.Tensor:
    """One K4 step with the card's clock recorded as ``sampler_scan_stamps``
    records K3's (``scan_stamps(1, L)`` stamps). Not counted as a launch of
    the main path."""
    L = pack["wqkv"].shape[0]
    _check_inputs("fused_sampler_step", pack, kmem, vmem, motion_t, emb_row, sc, z, const, n_heads, n_entries,
                  n_cur, d_motion, num_basis, use_indicator, coefficients, 1)
    stamps = torch.zeros(scan_stamps(1, L), dtype=torch.int64, device=motion_t.device)
    _launch("msmd_sampler_step", pack, kmem, vmem, motion_t, emb_row, sc, z, const, n_heads, n_entries, n_cur,
            d_motion, num_basis, use_indicator, sigmoid_alpha, coefficients, 1, stamps=stamps)
    return stamps


def fused_sampler_scan(pack: dict, kmem: torch.Tensor, vmem: torch.Tensor, motion_T: torch.Tensor,
                       emb_scan: torch.Tensor, sc_scan: torch.Tensor, z_scan: torch.Tensor, const: dict,
                       n_heads: int, n_entries: int, n_cur: int, d_motion: int, num_basis: int,
                       use_indicator: bool, sigmoid_alpha: bool, coefficients: Sequence[float]) -> torch.Tensor:
    """All T DDPM steps of one batch-1 window. motion_T (N, D) f32 ->
    motion x_0 (N, D) f32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (bf16 pack, head dim 64; one cooperative
    launch for the window) or raises, also where the
    card cannot hold the cooperative grid: there is no fallback."""
    args = (pack, kmem, vmem, motion_T, emb_scan, sc_scan, z_scan, const, n_heads, n_entries, n_cur, d_motion,
            num_basis, use_indicator, sigmoid_alpha, coefficients)
    if motion_T.device.type == "cpu":
        return fused_sampler_scan_plain(*args)
    if motion_T.device.type != "cuda":
        raise ValueError(f"fused_sampler_scan: unsupported device {motion_T.device}")
    T = z_scan.shape[0]
    _check_inputs("fused_sampler_scan", pack, kmem, vmem, motion_T, emb_scan, sc_scan, z_scan, const, n_heads,
                  n_entries, n_cur, d_motion, num_basis, use_indicator, coefficients, T)
    out = _launch("msmd_sampler_scan", *args, T)
    fused_sampler_scan.launches += 1
    return out


def fused_sampler_step(pack: dict, kmem: torch.Tensor, vmem: torch.Tensor, motion_t: torch.Tensor,
                       emb_row: torch.Tensor, sc: torch.Tensor, z: torch.Tensor, const: dict, n_heads: int,
                       n_entries: int, n_cur: int, d_motion: int, num_basis: int, use_indicator: bool,
                       sigmoid_alpha: bool, coefficients: Sequence[float]) -> torch.Tensor:
    """One DDPM step at batch 1. motion_t (N, D) f32 -> (N, D) f32. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (bf16
    pack, head dim 64; one cooperative launch for the step) or raises, also
    where the card cannot hold the cooperative grid: there is no
    fallback."""
    args = (pack, kmem, vmem, motion_t, emb_row, sc, z, const, n_heads, n_entries, n_cur, d_motion, num_basis,
            use_indicator, sigmoid_alpha, coefficients)
    if motion_t.device.type == "cpu":
        return fused_sampler_step_plain(*args)
    if motion_t.device.type != "cuda":
        raise ValueError(f"fused_sampler_step: unsupported device {motion_t.device}")
    _check_inputs("fused_sampler_step", pack, kmem, vmem, motion_t, emb_row, sc, z, const, n_heads, n_entries,
                  n_cur, d_motion, num_basis, use_indicator, coefficients, 1)
    out = _launch("msmd_sampler_step", *args, 1)
    fused_sampler_step.launches += 1
    return out


fused_sampler_scan.launches = 0
fused_sampler_step.launches = 0
