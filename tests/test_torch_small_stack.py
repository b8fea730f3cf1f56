"""The launch plan of the persistent small-row decoder stack
(``msmd_tpu_torch/ops/kernels/small_stack.py``, mirroring
``csrc/decoder_small.cuh``) that K3 and K1's flat-mask mode run as one
cooperative launch a step, and the two wrappers' CPU route. No card: the
kernels themselves are held to their plain twins by the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from msmd_tpu_torch.ops.kernels import small_stack as ss

FLAGSHIP = dict(lq=111, F=512, FF=2048, H=8, L=8)
# (Be, mode, extra): K3's step (two CFG entries, 100 motion rows, motion
# decoder 256 wide), the 2-slot round's identity band, batch 1 without the
# alignment mask (full cross), K4's step (K3's with the gathered cross)
FLAGSHIP_PLANS = [(2, "entry", dict(n_cur=100, Fd=256)), (4, "flat_band", {}), (2, "flat_full", {}),
                  (4, "flat_full", {}), (2, "flat_band", {}), (2, "entry_gather", dict(n_cur=100, Fd=256))]
TINY_PLANS = [(2, 15, 128, 256, 2, 2, "entry", dict(n_cur=11, Fd=64)), (3, 37, 128, 256, 2, 1, "flat_band", {}),
              (6, 37, 128, 256, 2, 2, "flat_full", dict(tile=3)), (1, 16, 256, 512, 4, 1, "flat_band", {}),
              (2, 15, 128, 256, 2, 2, "entry_gather", dict(n_cur=11, Fd=64))]


def _plans():
    for Be, mode, extra in FLAGSHIP_PLANS:
        for sms, per_sm in ((132, 2), (132, 1), (114, 2)):
            yield f"{mode}-Be{Be}-{sms}x{per_sm}", ss.small_stack_plan(Be, mode=mode, sms=sms, per_sm=per_sm,
                                                                         **FLAGSHIP, **extra)
    for Be, lq, F, FF, H, L, mode, extra in TINY_PLANS:
        yield f"{mode}-Be{Be}-lq{lq}-F{F}", ss.small_stack_plan(Be, lq, F, FF, H, mode, L=L, **extra)


PLANS = dict(_plans())


@pytest.mark.parametrize("key", sorted(PLANS))
def test_plan_covers_every_output_tile_once(key):
    """Every product phase's items cover each bm x 64 output tile of its
    M x N product, and each k of that tile's depth, exactly once."""
    plan = PLANS[key]
    for p in plan["phases"]:
        if p["kind"] != "gemm":
            continue
        g = p["gemm"]
        cover = np.zeros((-(-g["M"] // g["bm"]), g["N"] // ss.SB_BN, g["K"]), np.int32)
        for tm, tn, k0, k1 in ss.gemm_items(g):
            cover[tm, tn, k0:k1] += 1
        assert (cover == 1).all(), (key, p["name"], p["layer"])
        assert g["bm"] * cover.shape[0] >= g["M"] > g["bm"] * (cover.shape[0] - 1)
        assert p["items"] == len(ss.gemm_items(g))


@pytest.mark.parametrize("key", sorted(PLANS))
def test_split_k_slices_sum_to_the_full_depth_in_order(key):
    """A tile's split-K slices are consecutive items whose k ranges run
    from 0 to K in slot order, each a whole number of 64-deep k-steps."""
    for name, g in PLANS[key]["products"].items():
        items = ss.gemm_items(g)
        s = g["split"]
        assert g["K"] % (s * ss.SB_BK) == 0, (key, name)
        for t in range(0, len(items), s):
            tile = items[t:t + s]
            assert len({(tm, tn) for tm, tn, _, _ in tile}) == 1
            assert [k0 for _, _, k0, _ in tile] == [i * g["K"] // s for i in range(s)]
            assert tile[-1][3] == g["K"] and all(a[3] == b[2] for a, b in zip(tile, tile[1:]))


def test_split_k_partials_reassemble_the_product():
    """The partials of the plan's items, summed per output element in slot
    order as the consumer sums them, give the product (f32)."""
    rs = np.random.RandomState(0)
    for M, N, K, grid in ((222, 512, 2048, 264), (4, 512, 512, 264), (200, 256, 512, 132), (37, 128, 256, 8)):
        g = ss.plan_gemm(M, N, K, grid, True)
        a, b = rs.randn(M, K).astype(np.float32), rs.randn(K, N).astype(np.float32)
        part = np.zeros((g["split"], M, N), np.float32)
        for i, (tm, tn, k0, k1) in enumerate(ss.gemm_items(g)):
            r0, c0 = tm * g["bm"], tn * ss.SB_BN
            part[i % g["split"], r0:r0 + g["bm"], c0:c0 + ss.SB_BN] = \
                a[r0:r0 + g["bm"], k0:k1] @ b[k0:k1, c0:c0 + ss.SB_BN]
        total = part[0].copy()
        for s in range(1, g["split"]):
            total += part[s]
        np.testing.assert_allclose(total, a @ b, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("Be,mode,extra", FLAGSHIP_PLANS)
def test_every_phase_has_an_item_per_block_where_it_can(Be, mode, extra):
    """At the flagship shapes on 132 SMs, every product phase has at least
    min(its most items, grid) / 2 items and, where it can, no more than one
    round of the grid; the attention and row phases have their natural
    counts; the step is one launch of 1 + 11 L (+ 2 for K3) phases."""
    plan = ss.small_stack_plan(Be, mode=mode, sms=132, **FLAGSHIP, **extra)
    grid = plan["grid"]
    assert grid == 132 * ss.SMALL_PER_SM and plan["launches_per_step"] == 1
    k3 = "n_cur" in extra
    assert plan["phases_per_step"] == 1 + 11 * FLAGSHIP["L"] + (2 if k3 else 0)
    R, H, nt = Be * FLAGSHIP["lq"], FLAGSHIP["H"], -(-FLAGSHIP["lq"] // 16)
    for p in plan["phases"]:
        if p["kind"] == "gemm":
            g = p["gemm"]
            assert 2 * p["items"] >= min(ss.max_items(g), grid), (p["name"], p["items"])
            tiles = p["items"] // g["split"]
            assert p["items"] <= max(grid, tiles), (p["name"], p["items"])
        elif p["kind"] == "self_attention":
            assert p["items"] == Be * H * nt
        elif p["kind"] == "person_heads":
            assert p["items"] == Be * H
        elif p["kind"] == "layernorm":
            assert p["items"] == R
        elif p["kind"] == "masked_attention":
            assert p["items"] == H * -(-R // ss.MA_BQ)
    names = [p["name"] for p in plan["phases"]]
    assert names[0] == ("prologue" if k3 else "load")
    if k3:
        assert names[-2:] == ["motion_decoder", "epilogue"]


@pytest.mark.parametrize("kw,match", [
    (dict(F=512, H=16), "head dim"), (dict(F=200, H=2), "head dim"), (dict(FF=2000), "multiples of 128"),
    (dict(F=1152, H=18), "F <= 1024"), (dict(lq=1), "lq"), (dict(lq=129), "lq"), (dict(mode="blocks"), "mode"),
    (dict(mode="flat_band", tile=3), "divide"), (dict(Be=0), "entry"), (dict(Be=96), "exceeds"),
    (dict(mode="entry", n_cur=100, Fd=100), "motion decoder"), (dict(mode="entry", n_cur=111, Fd=256), "n_cur"),
    (dict(Be=10, tile=5), "chain"), (dict(Be=16, tile=8, mode="flat_band"), "chain"),
])
def test_plan_refuses_what_the_wrappers_refuse(kw, match):
    args = dict(Be=4, lq=111, F=512, FF=2048, H=8, mode="flat_full")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ss.small_stack_plan(**args)


@pytest.mark.parametrize("Be,lq,F,FF,chain", [(8, 111, 512, 2048, False), (9, 111, 512, 2048, False),
                                               (10, 111, 512, 2048, True), (96, 111, 512, 2048, True),
                                               (16, 64, 512, 2048, True), (20, 60, 128, 384, False)])
def test_flat_route_switches_at_the_hopper_gemm_rows(Be, lq, F, FF, chain):
    """The flat mode leaves the small stack where a layer's large product
    takes the Hopper GEMM: at 1024 rows and more, for a product whose
    widths that GEMM takes (at F 128 and FFN 384 none does)."""
    assert ss.flat_uses_chain(Be, lq, F, FF) is chain


@pytest.mark.parametrize("sms,per_sm", [(132, 1), (114, 1), (132, 2)])
def test_k4_step_plan_is_k3s_with_the_gathered_cross(sms, per_sm):
    """K4's step (mode "entry_gather") has K3's phases in K3's order with
    the same items, except that its cross output's product ``wco`` runs
    over all E * lq rows, split-K only where K / 64 divides, with at least
    as many items as K3's two-row one and no more than one round of the
    grid beyond its tiles."""
    k3 = ss.small_stack_plan(2, mode="entry", sms=sms, per_sm=per_sm, n_cur=100, Fd=256, **FLAGSHIP)
    k4 = ss.small_stack_plan(2, mode="entry_gather", sms=sms, per_sm=per_sm, n_cur=100, Fd=256, **FLAGSHIP)
    assert [(p["name"], p["kind"]) for p in k4["phases"]] == [(p["name"], p["kind"]) for p in k3["phases"]]
    assert k4["phases_per_step"] == 3 + 11 * FLAGSHIP["L"] and k4["launches_per_step"] == 1
    for a, b in zip(k3["phases"], k4["phases"]):
        if a["name"] != "wco":
            assert a["items"] == b["items"], a["name"]
    co = k4["products"]["co"]
    R, grid = 2 * FLAGSHIP["lq"], k4["grid"]
    assert (co["M"], co["N"], co["K"], co["bm"]) == (R, FLAGSHIP["F"], FLAGSHIP["F"], 64)
    assert (co["K"] // ss.SB_BK) % co["split"] == 0
    tiles = -(-R // 64) * FLAGSHIP["F"] // ss.SB_BN
    assert tiles * co["split"] <= max(grid, tiles) and 2 * tiles * co["split"] > min(grid, ss.max_items(co))
    assert k3["products"]["co"]["M"] == 2


def test_plan_rows_match_the_c_layout():
    """``plan_rows`` lists (kind, items, M, N, K, bm, split) as the C plans
    do, and ``c_plan_rows`` reads that layout back."""
    plan = ss.small_stack_plan(2, mode="entry", n_cur=100, Fd=256, **FLAGSHIP)
    rows = ss.plan_rows(plan)
    assert rows[0] == (ss.KINDS.index("rows"), 111, 0, 0, 0, 0, 0)
    assert rows[1][:3] == (ss.KINDS.index("gemm"), plan["phases"][1]["items"], 222)
    flat = [plan["grid"], plan["per_sm"], plan["smem"], len(rows)] + [v for r in rows for v in r]
    assert ss.c_plan_rows(flat) == {"grid": plan["grid"], "per_sm": plan["per_sm"], "smem": plan["smem"],
                                    "rows": rows}
    assert ss.SMALL_SMEM <= 227 * 1024 // ss.SMALL_PER_SM


def test_scan_stamps_count():
    from msmd_tpu_torch.ops.kernels import sampler as ks

    # one launch a window: its start, its token rows, then 11 L + 2 phases a step
    assert ks.scan_stamps(20, 8) == 2 + 20 * 90
    assert ks.scan_stamps(1, 2) == 2 + 24


def test_step_stamps_count_matches_the_plan():
    """K4's one launch a step stamps its start and the end of each phase
    of its plan."""
    from msmd_tpu_torch.ops.kernels import sampler as ks

    plan = ss.small_stack_plan(2, mode="entry_gather", n_cur=100, Fd=256, **FLAGSHIP)
    assert ks.scan_stamps(1, FLAGSHIP["L"]) == 1 + plan["phases_per_step"]


@pytest.mark.parametrize("width", [1, 0])
def test_flat_wrapper_on_cpu_tensors_takes_its_plain_twin(width):
    from msmd_tpu_torch.measure import decoder_flat_case
    from msmd_tpu_torch.ops.kernels import decoder as kd

    args = decoder_flat_case("cpu", Be=2, lq=9, width=width, F=128, H=2, L=2, FF=256, seed=3)
    pack = {k: v.float() if k.startswith("ln") else v for k, v in args[0].items()}
    args = (pack,) + args[1:]
    before = kd.fused_decoder_forward_flat.launches
    with torch.no_grad():
        got = kd.fused_decoder_forward_flat(*args)
        want = kd.fused_decoder_forward_plain(*args)
    assert kd.fused_decoder_forward_flat.launches == before
    assert torch.equal(got, want)


def test_step_wrapper_on_cpu_tensors_takes_its_plain_twin():
    from msmd_tpu_torch.measure import sampler_case
    from msmd_tpu_torch.ops.kernels import sampler as ks

    _, step, kw = sampler_case("cpu", P=2, N=5, F=128, H=2, L=2, FF=256, T=3)
    before = ks.fused_sampler_step.launches
    with torch.no_grad():
        got = ks.fused_sampler_step(*step, **kw)
        want = ks.fused_sampler_step_plain(*step, **kw)
    assert ks.fused_sampler_step.launches == before
    assert got.shape == (5, 67) and torch.equal(got, want)


def test_scan_wrapper_on_cpu_tensors_takes_its_plain_twin():
    from msmd_tpu_torch.measure import sampler_case
    from msmd_tpu_torch.ops.kernels import sampler as ks

    scan, _, kw = sampler_case("cpu", P=2, N=5, F=128, H=2, L=2, FF=256, T=3)
    before = ks.fused_sampler_scan.launches
    with torch.no_grad():
        got = ks.fused_sampler_scan(*scan, **kw)
        want = ks.fused_sampler_scan_plain(*scan, **kw)
    assert ks.fused_sampler_scan.launches == before
    assert got.shape == (5, 67) and torch.equal(got, want)
