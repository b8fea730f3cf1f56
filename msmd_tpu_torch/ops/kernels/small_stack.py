"""The launch plan of the persistent small-row decoder stack
(``csrc/decoder_small.cuh``) that K3 (``csrc/sampler.cu``, the batch-1
window), K4 (the same file, one step with K4's rounding) and K1's
flat-mask mode (``csrc/decoder.cu``) run as one cooperative launch: its
phases, the work items of each, the tile and split-K of each product, the
grid and the shared memory. Pure Python; it mirrors the C functions
``make_small_plan`` and ``small_phases``, which the libraries export as
``msmd_scan_plan``, ``msmd_step_plan`` and ``msmd_flat_plan`` (the card
tests hold them equal). The flat mode runs the stack only below the
Hopper GEMM's rows (``flat_uses_chain``); from there on it is a chain of
launches on that GEMM, which has no such plan.

A product M x N x K is cut into ``bm`` x 64 tiles (``bm`` 64, or 32 for
the person rows' products of at most 32 rows) and, where its
consumer sums partials (the N = F products: self-out, the cross q and out
projections, FFN2, and K3's and K4's motion decoder), into ``split``
slices of K:
the split doubles while the items still fit in one round of the grid and
K / 64 divides by it. Item i is slice ``i % split`` of tile ``i // split``,
the tile at row block ``t // (N // 64)`` and column block ``t % (N //
64)``. Each slice writes its own f32 partial and the consumer sums the
slices in slice order, so two calls give the same bits.
"""

from __future__ import annotations

from typing import List, Tuple

from msmd_tpu_torch.ops.kernels.gemm import H100_SMS, MIN_ROWS, SM90_BK

SB_BN = SB_BK = 64  # tile columns and depth of one k-step
SB_STAGES = 4  # the wmma tile's cp.async ring (the gathered person and motion rows)
WG_STAGES = 8  # the wgmma tile's TMA ring (every other product)
MA_BQ = 64  # query rows of a masked-attention block
DH = 64
MAX_LM = 128
SMALL_THREADS = 256
SMALL_PER_SM = 1  # the kernels' launch bound: one block an SM
C_LD = 20

# K3's per-entry band (f32 cross output); K1 flat: identity band, full
# cross; K4's per-entry band with the gathered cross output over every row
MODES = ("entry", "flat_band", "flat_full", "entry_gather")
KINDS = ("gemm", "self_attention", "masked_attention", "person_heads", "layernorm", "rows")


def _smem() -> int:
    sb = SB_STAGES * (64 + SB_BK) * (SB_BK + 8) * 2 + 8 * 16 * C_LD * 4  # the 64-row wmma tile's ring and staging
    wg = WG_STAGES * 2 * 64 * 128 + 1024 + 128 * 32 * 4 + WG_STAGES * 8  # ring, swizzle alignment, sums, mbarriers
    masked = MA_BQ * 128 + 2 * 2 * 2 * 64 * 128 + MA_BQ * DH * 4 + MA_BQ * 4 + (MAX_LM + 1) * 4  # Q, K/V, sums
    qtile = (16 + 2 * MAX_LM) * 128
    person = 2 * 128 * DH * 2 + (DH + 128 + 4 * DH + 8) * 4  # K and V chunks of 128 keys, sums
    return max(sb, wg, masked, qtile, person)


SMALL_SMEM = _smem()

_LAYER_NAMES = {
    "entry": ("qkv", "self_attention", "self_out", "ln1", "person_q", "person_attention", "wco", "cross_ln",
              "ffn1", "ffn2", "ln3"),
    "flat_band": ("qkv", "self_attention", "self_out", "ln1", "person_q", "person_attention", "wco", "cross_ln",
                  "ffn1", "ffn2", "ln3"),
    "flat_full": ("qkv", "self_attention", "self_out", "ln1", "cross_q", "cross_attention", "cross_out",
                  "cross_ln", "ffn1", "ffn2", "ln3"),
    "entry_gather": ("qkv", "self_attention", "self_out", "ln1", "person_q", "person_attention", "wco",
                     "cross_ln", "ffn1", "ffn2", "ln3"),
}
PHASES_PER_LAYER = 11


def plan_gemm(M: int, N: int, K: int, grid: int, split_ok: bool) -> dict:
    """One product's tile rows and split-K (``plan_gemm``)."""
    tn = N // SB_BN
    bm = 64 if M > 32 else 32
    tiles = -(-M // bm) * tn
    s = 1
    if split_ok:
        while 2 * s * tiles <= grid and (K // SB_BK) % (2 * s) == 0:
            s *= 2
    return {"M": M, "N": N, "K": K, "bm": bm, "split": s}


def gemm_items(p: dict) -> List[Tuple[int, int, int, int]]:
    """Every item of a product phase, in item order: (row block, column
    block, first k, end k)."""
    tn, s, kc = p["N"] // SB_BN, p["split"], p["K"] // p["split"]
    n = -(-p["M"] // p["bm"]) * tn * s
    return [((i // s) // tn, (i // s) % tn, (i % s) * kc, (i % s + 1) * kc) for i in range(n)]


def max_items(p: dict) -> int:
    """The most items a product phase could have at its tile: every 64-deep
    k-step its own slice where the consumer sums partials."""
    split_ok = p["split"] > 1 or p.get("split_ok", False)
    return -(-p["M"] // p["bm"]) * (p["N"] // SB_BN) * (p["K"] // SB_BK if split_ok else 1)


def flat_uses_chain(Be: int, lq: int, F: int, FF: int) -> bool:
    """Whether K1's flat mode runs its chain of launches rather than the
    small stack at these shapes (``csrc/decoder.cu::flat_chain``): where
    one of a layer's four large products takes the Hopper GEMM at Be * lq
    rows, at least ``MIN_ROWS`` (Be >= 10 at lq = 111)."""
    R = Be * lq
    wide = lambda N, K: R >= MIN_ROWS and K % SM90_BK == 0 and N % 256 == 0
    ln = lambda N, K: R >= MIN_ROWS and K % SM90_BK == 0 and N == 512
    return wide(3 * F, F) or wide(FF, F) or ln(F, F) or ln(F, FF)


def check_shapes(Be: int, lq: int, F: int, FF: int, H: int, mode: str, tile: int = 0) -> int:
    """Raise for what the small-stack kernels refuse (``small_shapes_ok``,
    the wrappers' checks); returns the tile (0 = all Be)."""
    if mode not in MODES:
        raise ValueError(f"small_stack_plan: unknown mode {mode!r} (one of {MODES})")
    if H < 1 or F % H or F // H != DH or F % 128 or FF % 128 or F > 1024:
        raise ValueError(f"small_stack_plan: needs head dim {DH}, F and FFN multiples of 128, F <= 1024 "
                         f"(F={F}, H={H}, FFN={FF})")
    if not 2 <= lq <= MAX_LM:
        raise ValueError(f"small_stack_plan: needs 2 <= lq <= {MAX_LM}, got {lq}")
    if Be < 1:
        raise ValueError(f"small_stack_plan: needs at least one entry, got {Be}")
    tile = tile or Be
    if mode.startswith("flat") and Be % tile:
        raise ValueError(f"small_stack_plan: tile {tile} does not divide {Be} entries")
    if mode.startswith("flat") and tile * lq > MAX_LM * MA_BQ:
        raise ValueError(f"small_stack_plan: a tile of {tile} x {lq} rows exceeds {MAX_LM * MA_BQ}")
    if mode.startswith("flat") and flat_uses_chain(Be, lq, F, FF):
        raise ValueError(f"small_stack_plan: at {Be * lq} rows the flat mode runs its chain on the Hopper GEMM")
    return tile


def small_stack_plan(Be: int, lq: int, F: int, FF: int, H: int, mode: str, sms: int = H100_SMS,
                     per_sm: int = SMALL_PER_SM, L: int = 8, tile: int = 0, n_cur: int = 0, Fd: int = 0,
                     grid: int = 0) -> dict:
    """The plan of one step: ``grid`` (``per_sm`` x ``sms`` blocks, or
    ``grid`` where given), ``smem`` (bytes a block), ``products`` (each
    product's M, N, K, bm, split) and ``phases``, in order: per phase its
    ``name``, ``layer`` (None outside the layers), ``kind`` (``KINDS``),
    ``items`` and, for a product, its plan. Mode "entry" with ``n_cur`` > 0
    is K3's step (its token rows before the layers, the motion decoder of
    the E * n_cur tail rows (width ``Fd``) and the epilogue rows after),
    "entry_gather" K4's (the same, its cross output's product ``co`` over
    every row); the flat modes start with the copy of x in. Every phase
    ends at a grid-wide barrier; the step is one launch."""
    tile = check_shapes(Be, lq, F, FF, H, mode, tile)
    entry = mode.startswith("entry")
    if entry and n_cur > 0 and (Fd % SB_BN or Fd < 1 or n_cur > lq - 1):
        raise ValueError(f"small_stack_plan: motion decoder width {Fd} must be a multiple of {SB_BN}, "
                         f"and n_cur {n_cur} <= lq - 1")
    grid = grid or per_sm * sms
    R, nt = Be * lq, -(-lq // 16)
    Mc = R if mode == "flat_full" else Be
    products = {"qkv": plan_gemm(R, 3 * F, F, grid, False), "self_out": plan_gemm(R, F, F, grid, True),
                "cq": plan_gemm(Mc, F, F, grid, True),
                "co": plan_gemm(R if mode == "entry_gather" else Mc, F, F, grid, True),
                "ffn1": plan_gemm(R, FF, F, grid, False), "ffn2": plan_gemm(R, F, FF, grid, True)}
    for name in ("self_out", "cq", "co", "ffn2"):
        products[name]["split_ok"] = True
    step = entry and n_cur > 0  # K3's or K4's sampler step
    if step:
        products["md"] = dict(plan_gemm(Be * n_cur, Fd, F, grid, True), split_ok=True)
    n_tiles, Rt = Be // tile, tile * lq
    masked = lambda rq: n_tiles * H * -(-rq // MA_BQ)
    layer_kinds = {
        "qkv": ("gemm", products["qkv"]),
        "self_attention": ("self_attention", Be * H * nt) if entry else ("masked_attention", masked(Rt)),
        "self_out": ("gemm", products["self_out"]), "ln1": ("layernorm", R),
        "person_q": ("gemm", products["cq"]), "cross_q": ("gemm", products["cq"]),
        "person_attention": ("person_heads", Be * H),
        "cross_attention": ("masked_attention", masked(Rt)),
        "wco": ("gemm", products["co"]), "cross_out": ("gemm", products["co"]), "cross_ln": ("layernorm", R),
        "ffn1": ("gemm", products["ffn1"]), "ffn2": ("gemm", products["ffn2"]), "ln3": ("layernorm", R),
    }

    def phase(name, layer, kind, what):
        if kind == "gemm":
            return {"name": name, "layer": layer, "kind": kind, "items": len(gemm_items(what)), "gemm": what}
        return {"name": name, "layer": layer, "kind": kind, "items": what, "gemm": None}

    phases = [phase("prologue" if step else "load", None, "rows", lq if step else R)]
    for l in range(L):
        for name in _LAYER_NAMES[mode]:
            kind, what = layer_kinds[name]
            phases.append(phase(name, l, kind, what))
    if step:
        phases.append(phase("motion_decoder", None, "gemm", products["md"]))
        phases.append(phase("epilogue", None, "rows", n_cur))
    return {"mode": mode, "grid": grid, "per_sm": per_sm, "smem": SMALL_SMEM, "products": products,
            "phases": phases, "phases_per_step": len(phases), "launches_per_step": 1}


def plan_rows(plan: dict) -> List[Tuple[int, int, int, int, int, int, int]]:
    """The plan's phases as the C plan lists them: (kind, items, M, N, K,
    bm, split), zeros where no product runs."""
    rows = []
    for p in plan["phases"]:
        g = p["gemm"]
        shape = (g["M"], g["N"], g["K"], g["bm"], g["split"]) if g else (0, 0, 0, 0, 0)
        rows.append((KINDS.index(p["kind"]), p["items"]) + shape)
    return rows


def c_plan_rows(out) -> dict:
    """A C plan (``msmd_scan_plan``, ``msmd_flat_plan``: grid, blocks per
    SM, shared memory, phases, then 7 numbers a phase) as
    {grid, per_sm, smem, rows}."""
    n = int(out[3])
    return {"grid": int(out[0]), "per_sm": int(out[1]), "smem": int(out[2]),
            "rows": [tuple(int(v) for v in out[4 + 7 * i:11 + 7 * i]) for i in range(n)]}
