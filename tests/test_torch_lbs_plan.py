"""K5's arithmetic and tiles on the CPU: the TF32 split the kernel makes
(``tf32_split_plain``), the three-product blend it runs on the tensor cores
(``skin_tf32_plain``) against the f32 plain version and an f64 product,
one TF32 product failing the card's f32-class check of 1e-5, the K-major
hi / lo bases of ``FusedFlame``, and ``lbs_plan``'s tiles covering every
frame and vertex once. Inputs are seeded with numpy at the flagship
magnitudes (``measure.lbs_case``)."""

import numpy as np
import pytest
import torch

from msmd_tpu_torch.measure import lbs_bound, lbs_case, lbs_work
from msmd_tpu_torch.models.flame import synthetic_flame
from msmd_tpu_torch.ops.kernels import lbs as kl


def _f64_skin(fused, betas_ext, rt):
    planes = fused.template.double()[:, None, :] + torch.einsum("bk,ckv->cbv", betas_ext.double(),
                                                                 fused.dirs.double())
    N = betas_ext.shape[0]
    R = rt.double().reshape(N, kl.N_JOINTS, 12)
    out = torch.zeros_like(planes)
    for j in range(kl.N_JOINTS):
        w = fused.weights_t.double()[j][None, :]
        for d in range(3):
            r = R[:, j, 4 * d: 4 * d + 4]
            out[d] += w * (r[:, 0:1] * planes[0] + r[:, 1:2] * planes[1] + r[:, 2:3] * planes[2] + r[:, 3:4])
    return out.permute(1, 2, 0)[:, : fused.n_verts]


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_tf32_split_keeps_ten_mantissa_bits_and_the_rest_in_lo(scale):
    rs = np.random.RandomState(0)
    x = torch.as_tensor((rs.randn(4096) * scale).astype(np.float32))
    hi, lo = kl.tf32_split_plain(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -21 * x.double().abs()).all())
    # round to nearest: hi is within half a TF32 unit of x
    assert bool(((x.double() - hi.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())


def test_tf32_split_rounds_ties_away_from_zero():
    one_and_half_unit = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    hi, lo = kl.tf32_split_plain(one_and_half_unit)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    assert lo.tolist() == [-(2.0 ** -11), 2.0 ** -11]


@pytest.mark.parametrize("V", [37, 300])
def test_three_tf32_products_hold_f32_accuracy(V):
    """lo.hi + hi.lo + hi.hi stays within 1e-6 of the f32 plain version and
    of the f64 product at the batch-48 window's magnitudes."""
    fused, (betas_ext, rt) = lbs_case("cpu", N=512, V=V)
    got = kl.skin_tf32_plain(fused, betas_ext, rt)
    assert got.shape == (512, V, 3)
    assert float((got - kl.skin_plain(fused, betas_ext, rt)).abs().max()) <= 1e-6
    assert float((got.double() - _f64_skin(fused, betas_ext, rt)).abs().max()) <= 1e-6


def test_one_tf32_product_misses_the_f32_class_check():
    """At N = 4800 frames (a batch-48 window) one TF32 product is off by
    more than the card's 1e-5 check, three are not: the check has teeth."""
    fused, (betas_ext, rt) = lbs_case("cpu", N=4800, V=37)
    want = _f64_skin(fused, betas_ext, rt)
    one = float((kl.skin_tf32_plain(fused, betas_ext, rt, passes=1).double() - want).abs().max())
    three = float((kl.skin_tf32_plain(fused, betas_ext, rt).double() - want).abs().max())
    assert one > 1e-5 and three <= 1e-6, (one, three)
    with pytest.raises(ValueError, match="passes"):
        kl.skin_tf32_plain(fused, betas_ext, rt, passes=2)


@pytest.mark.parametrize("V", [37, 300])
def test_k_major_bases_split_the_plain_layout(V):
    fused = kl.FusedFlame(synthetic_flame(n_verts=V, device="cpu"))
    assert fused.kbp == 192 and fused.n_basis == 186 and fused.vp == 128 * -(-V // 128)
    for t in (fused.dirs_hi, fused.dirs_lo):
        assert t.shape == (3, fused.vp, fused.kbp) and t.dtype == torch.float32 and t.is_contiguous()
    km = fused.dirs.transpose(1, 2).double()
    total = fused.dirs_hi.double() + fused.dirs_lo.double()
    assert bool(((total[..., :186] - km).abs() <= 2.0 ** -21 * km.abs()).all())
    assert bool((fused.dirs_hi[..., 186:] == 0).all()) and bool((fused.dirs_lo[..., 186:] == 0).all())
    assert bool((fused.dirs_hi[:, V:] == 0).all())


@pytest.mark.parametrize("N", [1, 100, 3200, 4800])
@pytest.mark.parametrize("V", [37, 5023])
def test_plan_covers_every_frame_and_vertex_once(N, V):
    """The kernel's walk: block b takes tiles b, b + grid, ..., tile t at
    frame (t % frame_tiles) x 128 and vertex (t // frame_tiles) x vw."""
    plan = kl.lbs_plan(N, V)
    assert plan["vw"] == kl.LBS_VERTICES and plan["launches"] == 2
    assert plan["grid"] == min(plan["tiles"], kl.H100_SMS)
    seen = np.zeros((plan["frame_tiles"] * plan["frames"], plan["vertex_tiles"] * plan["vw"]), np.int32)
    for b in range(plan["grid"]):
        for t in range(b, plan["tiles"], plan["grid"]):
            f0, v0 = (t % plan["frame_tiles"]) * plan["frames"], (t // plan["frame_tiles"]) * plan["vw"]
            seen[f0:f0 + plan["frames"], v0:v0 + plan["vw"]] += 1
    assert (seen[:N, :V] == 1).all() and seen.sum() == plan["tiles"] * plan["frames"] * plan["vw"]


def test_plan_at_batch_1_and_batch_48():
    """128 x 64 tiles: 79 blocks at a batch-1 window, every SM at batch 48."""
    assert kl.lbs_plan(100, 5023) == dict(vw=64, frames=128, frame_tiles=1, vertex_tiles=79, tiles=79, grid=79,
                                          launches=2)
    assert kl.lbs_plan(4800, 5023)["tiles"] == 38 * 79 and kl.lbs_plan(4800, 5023)["grid"] == 132
    assert kl.lbs_plan(4800, 5023, sms=114)["grid"] == 114
    with pytest.raises(ValueError):
        kl.lbs_plan(0, 5023)


def test_bound_is_three_tf32_products_at_the_batch_48_window():
    """K5's bound at N = 4800, V = 5023: 3 x 26.9 GFLOP at 495 TFLOP/s, by
    operations; the whole function on the f32 CUDA cores 0.450 ms."""
    fused = kl.FusedFlame(synthetic_flame(n_verts=5023, device="cpu"))
    betas_ext, rt = torch.zeros(4800, fused.n_basis), torch.zeros(4800, 60)
    blend, skin, nbytes = lbs_work(fused, betas_ext, rt)
    assert blend == 2 * 4800 * 5023 * 3 * 186 and skin == 4800 * 5023 * 135
    ms, by, f32_ms = lbs_bound(blend, skin, nbytes)
    assert by == "operations" and abs(ms - 0.1631) < 1e-3 and abs(f32_ms - 0.4502) < 1e-3
