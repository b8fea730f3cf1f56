"""The port's espnet loss, auxiliary losses and dict truncation
(``msmd_tpu_torch/losses.py``) against ``msmd_tpu/losses.py`` on the same
NumPy inputs, on the CPU, in every branch each has:

- ``compute_loss_espnet``: the noise target and the sample target, first
  and later clips, truncated or not, l1 and l2, ``no_constrain_prev``,
  ``no_head_pose`` and the vertex terms off;
- ``style_adherence_loss``: soft-min reduced and per frame, hard-min;
- ``nt_xent_loss`` at two temperatures;
- ``truncate_coef_dict_and_audio``: zero and replicate padding, with the
  ends JAX drew handed to the port.

Tolerance: rtol 1e-6 (float32 reductions over the same terms) except
where noted.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu import losses as jl
from msmd_tpu.config import MSMDConfig as JCfg
from msmd_tpu_torch import losses as tl
from msmd_tpu_torch.config import MSMDConfig

V = 20


def _cfgs(**kw):
    base = dict(n_motions=12, n_prev_motions=5, l_vert=1.0, l_vel=1.0, l_smooth=1.0, l_head_angle=1.0,
                l_head_vel=1.0, l_head_smooth=1.0, l_head_trans=1.0)
    base.update(kw)
    return JCfg(**base), MSMDConfig(**base)


def _close(a, b, rtol=1e-6):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=1e-7)


def _espnet_case(jc, tc, starting, truncated, seed):
    rs = np.random.RandomState(seed)
    B, n, P = 3, jc.n_motions, jc.n_prev_motions
    L = n if starting else P + n
    arrays = dict(gt=rs.randn(B, n, 58), noise=rs.randn(B, n, 58), pred=rs.randn(B, P + n, 58),
                  prev=rs.randn(B, P, 58), shape=rs.randn(B, 100), gtv=rs.randn(B, L, V, 3),
                  seqv=rs.randn(B, L, V, 3))
    a = {k: v.astype(np.float32) for k, v in arrays.items()}
    end = np.array([4, n, 9], np.int32) if truncated else None
    want = jl.compute_loss_espnet(jc, starting, a["shape"], a["gt"], a["noise"], a["pred"], a["prev"], None,
                                  a["gtv"], a["seqv"], None if end is None else jnp.asarray(end))
    t = torch.from_numpy
    got = tl.compute_loss_espnet(tc, starting, t(a["shape"]), t(a["gt"]), t(a["noise"]), t(a["pred"]),
                                 t(a["prev"]), None, t(a["gtv"]), t(a["seqv"]),
                                 None if end is None else t(end).long())
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    return got


@pytest.mark.parametrize("target", ["sample", "noise"])
@pytest.mark.parametrize("criterion", ["l2", "l1"])
@pytest.mark.parametrize("starting", [True, False])
@pytest.mark.parametrize("truncated", [False, True])
def test_compute_loss_espnet_matches_jax(target, criterion, starting, truncated):
    jc, tc = _cfgs(target=target, criterion=criterion)
    got = _espnet_case(jc, tc, starting, truncated, seed=sum(map(ord, f"{target}{criterion}{starting}{truncated}")))
    if target == "sample":
        assert float(got["vert"]) > 0 and float(got["head_angle"]) > 0
        assert (float(got["head_trans"]) > 0) == (not starting)
    else:
        assert all(float(got[k]) == 0 for k in got if k != "noise")


@pytest.mark.parametrize("kw", [dict(no_constrain_prev=True), dict(no_head_pose=True),
                                dict(l_vert=0.0, l_vel=0.0), dict(l_smooth=0.0, l_head_trans=0.0)])
def test_compute_loss_espnet_options_match_jax(kw):
    jc, tc = _cfgs(**kw)
    for starting in (True, False):
        _espnet_case(jc, tc, starting, truncated=True, seed=11)


@pytest.mark.parametrize("soft,reduce", [(True, True), (True, False), (False, True)])
def test_style_adherence_loss_matches_jax(soft, reduce):
    rs = np.random.RandomState(1)
    x = rs.randn(3, 10, 58).astype(np.float32)
    style = rs.randn(3, 7, 58).astype(np.float32)
    want = jl.style_adherence_loss(jnp.asarray(x), jnp.asarray(style), use_soft_min=soft, lambda_softmin=3.0,
                                   reduce=reduce)
    got = tl.style_adherence_loss(torch.as_tensor(x), torch.as_tensor(style), use_soft_min=soft,
                                  lambda_softmin=3.0, reduce=reduce)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("temperature", [0.1, 0.5])
def test_nt_xent_loss_matches_jax(temperature):
    rs = np.random.RandomState(2)
    a, b = rs.randn(6, 32).astype(np.float32), rs.randn(6, 32).astype(np.float32)
    want = jl.nt_xent_loss(jnp.asarray(a), jnp.asarray(b), temperature)
    got = tl.nt_xent_loss(torch.as_tensor(a), torch.as_tensor(b), temperature)
    _close(got, want, rtol=1e-5)
    # two equal views score lower than two unrelated ones
    assert float(tl.nt_xent_loss(torch.as_tensor(a), torch.as_tensor(a), temperature)) < float(got)


@pytest.mark.parametrize("pad_mode", ["zero", "replicate"])
def test_truncate_coef_dict_and_audio_matches_jax(pad_mode):
    rs = np.random.RandomState(3)
    B, n = 4, 12
    audio = rs.randn(B, n * 640).astype(np.float32)
    coefs = {"exp": rs.randn(B, n, 50).astype(np.float32), "pose": rs.randn(B, n, 6).astype(np.float32),
             "shape": rs.randn(B, n, 100).astype(np.float32)}
    ja, jd, end = jl.truncate_coef_dict_and_audio(jax.random.PRNGKey(4), jnp.asarray(audio),
                                                  {k: jnp.asarray(v) for k, v in coefs.items()}, n,
                                                  pad_mode=pad_mode)
    ta, td = tl.truncate_coef_dict_and_audio(torch.as_tensor(audio), {k: torch.as_tensor(v) for k, v in coefs.items()},
                                             torch.as_tensor(np.array(end)).long(), pad_mode=pad_mode)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    with pytest.raises(ValueError, match="pad mode"):
        tl.truncate_coef_dict_and_audio(torch.as_tensor(audio), {}, torch.ones(B, dtype=torch.long), pad_mode="x")
