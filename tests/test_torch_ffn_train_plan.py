"""K7's launch plan and the LayerNorm backward of its wgmma route, on the
CPU (``msmd_tpu_torch/ops/kernels/ffn_train.py``): ``ffn_train_plan``
(mirrored by the library's ``msmd_ffn_train_plan``; a card test holds the
two equal) and ``ln_backward_pair_plain``, the plain twin of the epilogue
that takes each row's LayerNorm from two 256-column halves held by two
CTAs.

Tolerance: the pair-split backward against the whole-row
``ffn_train_backward_plain`` in f32, max |err| <= 1e-6 x max |whole-row|
for each of the seven gradients: the same arithmetic but for the order of
the row sums and Chan et al.'s combination of the halves' variances
(measured 1.3e-7 to 3.3e-7).
"""

import pytest
import torch

from msmd_tpu_torch.ops.kernels import ffn_train as k7

ROWS = (100, 1024, 1040, 1776, 1777)
NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dg", "db")


def _blocks(n: int, size: int):
    return list(range(0, n, size))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("rows", ROWS)
def test_plan_covers_every_output_tile_once(rows, backward):
    plan = k7.ffn_train_plan(rows, 512, 2048, backward)
    if rows < k7.MIN_ROWS:
        assert plan["route"] == "wmma" and plan["products"] == {}
        return
    assert plan["route"] == "wgmma"
    want = {"ffn1", "ffn2"} | ({"dh", "dx", "dw1", "dw2"} if backward else set())
    assert set(plan["products"]) == want
    for name, prod in plan["products"].items():
        M, N = prod["M"], prod["N"]
        tiles = [(t["m0"], t["n0"]) for t in prod["tiles"]]
        assert len(tiles) == len(set(tiles)), name
        assert sorted(tiles) == [(m, n) for m in _blocks(M, k7.TILE_M) for n in _blocks(N, k7.TILE_N)], name
        assert N % k7.TILE_N == 0 and (name not in ("dw1", "dw2") or M % k7.TILE_M == 0), name


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("rows", ROWS[1:])
def test_plan_k_ranges_cover_k_in_order(rows, backward):
    """Every tile sums K in contiguous ranges from 0 in a fixed order; the
    weight gradients' ranges are the row chunks: [0, R) exactly, ragged
    tail included, each boundary inside on a whole 64-row k-step."""
    plan = k7.ffn_train_plan(rows, 512, 2048, backward)
    for name, prod in plan["products"].items():
        for t in prod["tiles"]:
            ranges = t["k"]
            assert ranges[0][0] == 0 and ranges[-1][1] == prod["K"], name
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), name
            assert all(lo < hi for lo, hi in ranges), name
            assert all(hi % k7.TILE_K == 0 for _, hi in ranges[:-1]), name
        if name in ("dw1", "dw2"):
            assert prod["K"] == rows and len(prod["tiles"][0]["k"]) == plan["row_chunks"], name
        if name in ("ffn2", "dx"):
            assert prod["cluster"] == k7.CLUSTER and len(prod["tiles"][0]["k"]) == 2, name


@pytest.mark.parametrize("rows", [1024, 1040, 1776, 1777])
def test_plan_launches_and_grids(rows):
    """The forward is 2 launches and the backward 6; the weight gradients'
    two row chunks with their 64 tiles fill 128 of the H100's 132 SMs; the
    last pass takes 32 columns of db1, db2, dg and db a block."""
    fwd, bwd = k7.ffn_train_plan(rows, 512, 2048, False), k7.ffn_train_plan(rows, 512, 2048, True)
    rb = -(-rows // 128)
    assert (fwd["launches"], bwd["launches"]) == (2, 6)
    assert fwd["grids"] == [rb * 8, 4 * rb]
    assert bwd["row_chunks"] == 2
    assert bwd["grids"] == [rb * 8, 4 * rb, rb * 8, 4 * rb, 128, (2048 + 3 * 512) // 32]
    assert len(bwd["products"]["dx"]["tiles"]) * 2 == bwd["grids"][3]  # two K-slices a tile
    assert (len(bwd["products"]["dw1"]["tiles"]) + len(bwd["products"]["dw2"]["tiles"])) * 2 == bwd["grids"][4]


@pytest.mark.parametrize("rows,F,FF,route", [(1776, 512, 2048, "wgmma"), (1023, 512, 2048, "wmma"),
                                             (1776, 256, 1024, "wmma"), (1776, 512, 1024, "wgmma"),
                                             (1776, 512, 384, "wmma"), (100, 128, 256, "wmma")])
def test_plan_routes_by_shape(rows, F, FF, route):
    for backward, launches in ((False, {"wgmma": 2, "wmma": 3}), (True, {"wgmma": 6, "wmma": 15})):
        plan = k7.ffn_train_plan(rows, F, FF, backward)
        assert plan["route"] == route and plan["launches"] == launches[route]


@pytest.mark.parametrize("rows,F,FF", [(1776, 500, 2048), (1776, 512, 2000), (0, 512, 2048), (1776, 1152, 2048)])
def test_plan_refuses_what_neither_route_takes(rows, F, FF):
    with pytest.raises(ValueError, match="ffn_train"):
        k7.ffn_train_plan(rows, F, FF, True)


@pytest.mark.parametrize("K,halves", [(2048, [(0, 1024), (1024, 2048)]), (1776, [(0, 896), (896, 1776)]),
                                      (1777, [(0, 896), (896, 1777)]), (1040, [(0, 576), (576, 1040)]),
                                      (1024, [(0, 512), (512, 1024)])])
def test_k_halves_split_whole_k_steps(K, halves):
    """A split product's two K-slices: the first ceil(k-steps / 2) 64-deep
    k-steps, then the rest (the last one ragged where K is)."""
    assert k7.k_halves(K) == halves


def _case(rows, F, FF, seed):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g)
    return (rn(rows, F), rn(FF, F) / F ** 0.5, rn(FF) * 0.1, rn(F, FF) / FF ** 0.5, rn(F) * 0.1,
            1.0 + 0.1 * rn(F), 0.1 * rn(F)), rn(rows, F)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("rows,FF", [(48, 256), (300, 512)])
def test_pair_split_layernorm_backward_matches_whole_row(rows, FF, p):
    (x, w1, b1, w2, b2, g, b), gbar = _case(rows, 512, FF, seed=rows + FF)
    whole = k7.ffn_train_backward_plain(x, gbar, w1, b1, w2, b2, g, b, 1234, p)
    pair = k7.ffn_train_backward_pair_plain(x, gbar, w1, b1, w2, b2, g, b, 1234, p)
    for name, a, w in zip(NAMES, pair, whole):
        assert a.dtype == w.dtype == torch.float32 and a.shape == w.shape, name
        assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max()), name


@pytest.mark.parametrize("shift", [0.0, 30.0])
def test_pair_split_statistics_match_the_whole_row(shift):
    """yhat from the halves' sums and squared deviations (Chan et al.)
    against the whole row's two-pass mean and variance, also for rows whose
    halves have far apart means."""
    g = torch.Generator().manual_seed(5)
    r = torch.randn(64, 512, generator=g)
    r[:, 256:] += shift
    gbar, gamma = torch.randn(64, 512, generator=g), 1.0 + 0.1 * torch.randn(512, generator=g)
    yh, dr = k7.ln_backward_pair_plain(r, gbar, gamma)
    mu = r.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt((r - mu).square().mean(dim=-1, keepdim=True) + 1e-5)
    want = (r - mu) * rs
    dyh = gbar * gamma
    want_dr = rs * (dyh - dyh.mean(dim=-1, keepdim=True) - want * (dyh * want).mean(dim=-1, keepdim=True))
    assert float((yh - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert float((dr - want_dr).abs().max()) <= 1e-6 * float(want_dr.abs().max())
