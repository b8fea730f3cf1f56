"""The port's loss suite (``msmd_tpu_torch/losses.py``) against
``msmd_tpu/losses.py`` on the same NumPy inputs, on the CPU: the
parameter-space terms over the target modes, criteria, clip positions and
truncation masks; the KL term; truncation with the same ends; the loss
weights. Tolerance: rtol 1e-6 (float32 reductions in the same order of
terms)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu import losses as jl
from msmd_tpu.config import MSMDConfig as JCfg
from msmd_tpu_torch import losses as tl
from msmd_tpu_torch.config import MSMDConfig


def _cfgs(**kw):
    base = dict(n_motions=12, n_prev_motions=5)
    base.update(kw)
    return JCfg(**base), MSMDConfig(**base)


def _close(a, b):
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("target", ["sample", "noise"])
@pytest.mark.parametrize("criterion", ["l2", "l1"])
@pytest.mark.parametrize("starting", [True, False])
@pytest.mark.parametrize("truncated", [False, True])
def test_compute_loss_no_vert_matches_jax(target, criterion, starting, truncated):
    jc, tc = _cfgs(target=target, criterion=criterion)
    rs = np.random.RandomState(hash((target, criterion, starting, truncated)) % 2 ** 31)
    B, n, P = 3, jc.n_motions, jc.n_prev_motions
    gt = rs.randn(B, n, 67).astype(np.float32)
    noise = rs.randn(B, n, 67).astype(np.float32)
    pred = rs.randn(B, P + n, 67).astype(np.float32)
    prev = rs.randn(B, P, 67).astype(np.float32)
    shape = rs.randn(B, 100).astype(np.float32)
    end = np.array([4, n, 9], np.int32) if truncated else None
    want = jl.compute_loss_no_vert(jc, starting, shape, gt, noise, pred, prev, None, None,
                                   None if end is None else jnp.asarray(end))
    t = torch.from_numpy
    got = tl.compute_loss_no_vert(tc, starting, t(shape), t(gt), t(noise), t(pred), t(prev),
                                  None if end is None else t(end).long())
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_no_constrain_prev_and_no_head_pose():
    for kw in (dict(no_constrain_prev=True), dict(no_head_pose=True), dict(l_vel=0.0, l_smooth=0.0)):
        jc, tc = _cfgs(**kw)
        rs = np.random.RandomState(7)
        B, n, P = 2, jc.n_motions, jc.n_prev_motions
        args = [rs.randn(B, n, 67), rs.randn(B, n, 67), rs.randn(B, P + n, 67), rs.randn(B, P, 67)]
        args = [a.astype(np.float32) for a in args]
        want = jl.compute_loss_no_vert(jc, False, None, *args)
        got = tl.compute_loss_no_vert(tc, False, None, *(torch.from_numpy(a) for a in args))
        for k in want:
            _close(got[k], want[k])


def test_kl_loss_matches_jax():
    rs = np.random.RandomState(1)
    mu, lv = rs.randn(4, 16).astype(np.float32), rs.randn(4, 16).astype(np.float32) * 0.3
    _close(tl.compute_kl_loss(torch.from_numpy(mu), torch.from_numpy(lv)), jl.compute_kl_loss(mu, lv))


@pytest.mark.parametrize("pad_mode", ["zero", "replicate"])
def test_truncation_with_the_same_ends_matches_jax(pad_mode):
    rs = np.random.RandomState(2)
    B, n, unit = 5, 20, 640.0
    audio = rs.randn(B, int(n * unit)).astype(np.float32)
    motion = rs.randn(B, n, 67).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ja, jm, jend = jl.truncate_motion_coef_and_audio(key, audio, motion, n, unit, pad_mode)
    ta, tm = tl.truncate_motion_coef_and_audio(torch.from_numpy(audio), torch.from_numpy(motion),
                                               torch.from_numpy(np.array(jend)).long(), unit, pad_mode)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("kw", [dict(), dict(use_vertex_space=True), dict(dataset_type="HDTF_TFHP_x"),
                                dict(dataset_type="HDTF_TFHP_x", use_vertex_space=True),
                                dict(training_loss_style="other", l_vel=0.3)])
def test_loss_weights_match_jax(kw):
    jc, tc = _cfgs(**kw)
    want, got = jl.load_loss_weights(jc), tl.load_loss_weights(tc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_masked_mean_of_an_empty_mask_is_zero():
    x = torch.ones(2, 3, 4)
    assert float(tl._masked_mean(x, torch.zeros(2, 3, dtype=torch.bool))) == 0.0


@pytest.mark.parametrize("target", ["sample", "noise"])
@pytest.mark.parametrize("starting", [True, False])
def test_rank_shares_of_a_truncated_batch_average_to_jax(target, starting):
    """Two data-parallel ranks' losses on their halves of a truncated batch
    (``end_idx_all``: the global ends), averaged, equal JAX's loss on the
    whole batch, though the halves hold different frame counts."""
    jc, tc = _cfgs(target=target)
    rs = np.random.RandomState(11)
    B, n, P = 4, jc.n_motions, jc.n_prev_motions
    gt, noise = rs.randn(B, n, 67).astype(np.float32), rs.randn(B, n, 67).astype(np.float32)
    pred, prev = rs.randn(B, P + n, 67).astype(np.float32), rs.randn(B, P, 67).astype(np.float32)
    end = np.array([2, 3, n, 9], np.int32)
    want = jl.compute_loss_no_vert(jc, starting, None, gt, noise, pred, prev, None, None, jnp.asarray(end))
    t = torch.from_numpy
    halves = [tl.compute_loss_no_vert(tc, starting, None, t(gt[r]), t(noise[r]), t(pred[r]), t(prev[r]),
                                      t(end[r]).long(), t(end).long()) for r in (slice(0, 2), slice(2, 4))]
    for k in want:
        _close((halves[0][k] + halves[1][k]) / 2, want[k])
