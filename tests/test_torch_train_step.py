"""The port's two-clip training step (``msmd_tpu_torch/train/loop.py``)
against ``msmd_tpu/train/loop.py`` on the CPU, at the tiny geometry:

- the deterministic two-clip loss (eval mode: no dropout, truncation or
  cross-style swap; no CFG drop; fixed timesteps and noise; a style
  encoder that returns its mean) and its gradient for every trainable
  parameter, against ``jax.grad`` of the same JAX calls: f32, the loss to
  rtol 1e-5 and each gradient to 1e-4 x max|g| + 1e-6;
- one Adam update against optax's ``make_optimizer`` (two updates, at
  gradient accumulation 1 and 2, from the same gradients): atol 1e-6;
- the learning-rate schedules, to rtol 1e-6 (equal but for the last bit
  of float32 cos, where NumPy and XLA may round differently);
- the frozen parameters do not move, the trainable ones do;
- 20 steps on one batch lower the loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util
from torch import nn

from msmd_tpu_torch.config import MSMDConfig
from msmd_tpu_torch.interop import flax_tree, load_flax_params
from msmd_tpu_torch.train import loop as tloop

from test_torch_common import build_msmd_pair, np_params


def _batch(cfg, B=2, seed=0):
    rs = np.random.RandomState(seed)
    L_a = cfg.n_audio_samples
    return {
        "audio_0": rs.randn(B, L_a).astype(np.float32), "audio_1": rs.randn(B, L_a).astype(np.float32),
        "motion_0": rs.randn(B, cfg.n_motions, 67).astype(np.float32),
        "motion_1": rs.randn(B, cfg.n_motions, 67).astype(np.float32),
        "shape_0": rs.randn(B, cfg.n_motions, 100).astype(np.float32),
        "shape_1": np.zeros((B, cfg.n_motions, 100), np.float32),
    }


def _style_pair(d_style, seed=0):
    from msmd_tpu.models.style_encoder import StyleEncoderVAE2 as JVAE2
    from msmd_tpu_torch.models.style_encoder import StyleEncoderVAE2

    jenc = JVAE2(d_style=d_style)
    variables = jenc.init({"params": jax.random.PRNGKey(seed), "style": jax.random.PRNGKey(1)},
                          np.zeros((1, 8, 67), np.float32))
    return jenc, np_params(variables), load_flax_params(StyleEncoderVAE2(d_style=d_style), np_params(variables))


class _JaxMeanStyle:
    """The JAX style encoder with z = mu (its eps draw removed)."""

    def __init__(self, enc):
        self.enc = enc

    def apply(self, variables, x, deterministic=True, rngs=None):
        mu, logvar = self.enc.apply(variables, x, deterministic, method=type(self.enc)._encode)
        return mu, mu, logvar


class _MeanStyle(nn.Module):
    def __init__(self, enc):
        super().__init__()
        self.enc = enc

    def forward(self, x, generator=None, train=False):
        mu, logvar = self.enc.encode(x, generator if train else None)
        return mu, mu, logvar


def test_two_clip_loss_and_grads_match_jax(monkeypatch):
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.ops.schedule import DiffusionSchedule
    from msmd_tpu.train.loop import trainable_mask, two_clip_loss as jloss

    jmodel, variables, tmodel, kw = build_msmd_pair(batch=2, use_cross_style=True, do_ignore_cfg=True)
    jcfg, cfg = JCfg(**kw), MSMDConfig(**kw)
    jenc, sparams, tenc = _style_pair(kw["d_style"])
    params = {"model": np_params(variables), "style_enc": sparams}
    batch = _batch(cfg)
    rs = np.random.RandomState(5)
    noise = [rs.randn(2, cfg.n_motions, 67).astype(np.float32) for _ in range(2)]
    steps = [np.array([1, 3]), np.array([4, 2])]
    drawn = iter(steps * 2)
    monkeypatch.setattr(DiffusionSchedule, "uniform_sample_t", lambda self, key, n: jnp.asarray(next(drawn)))

    def loss_fn(p):
        return jloss(jcfg, jmodel, _JaxMeanStyle(jenc), p, {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.PRNGKey(0), train=False, noise_pair=tuple(jnp.asarray(n) for n in noise))

    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tloop.freeze(cfg, tmodel)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = tloop.two_clip_loss(cfg, tmodel, _MeanStyle(tenc), tb, torch.Generator().manual_seed(0),
                                         train=False, noise_pair=[torch.from_numpy(n) for n in noise],
                                         time_steps=[torch.from_numpy(s) for s in steps])
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)

    mask = traverse_util.flatten_dict(trainable_mask(jcfg, params))
    want = traverse_util.flatten_dict(jgrads)
    got = {("model",) + k: v for k, v in traverse_util.flatten_dict(flax_tree(tmodel, grads=True)).items()}
    got.update({("style_enc",) + k: v for k, v in traverse_util.flatten_dict(flax_tree(tenc, grads=True)).items()})
    trainable = {k for k, v in mask.items() if v}
    assert set(got) <= trainable and len(got) > 0.9 * len(trainable)
    for k in trainable - set(got):  # not on this loss's graph (null embeddings, SpecAugment's): JAX gives 0
        assert not np.asarray(want[k]).any(), k
    for k, g in got.items():
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-6, k


def _tiny(**kw):
    base = dict(feature_dim=32, n_heads=4, n_layers=2, mlp_ratio=2, d_style=16, num_of_basis=2, n_motions=8,
                n_prev_motions=4, n_diff_steps=4, use_indicator=True, use_cross_style=True, lr=1e-3, warm_iter=3)
    base.update(kw)
    return base


@pytest.mark.parametrize("accum", [1, 2])
def test_adam_update_matches_optax(accum):
    import optax
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.train.loop import make_optimizer

    jmodel, variables, tmodel, kw = build_msmd_pair(batch=1, **_tiny(gradient_accumulation_steps=accum))
    jcfg, cfg = JCfg(**kw), MSMDConfig(**kw)
    _, sparams, tenc = _style_pair(kw["d_style"])
    params = {"model": np_params(variables), "style_enc": sparams}
    tloop.freeze(cfg, tmodel)
    opt = tloop.TrainOptimizer(cfg, list(tmodel.parameters()) + list(tenc.parameters()))
    tx = make_optimizer(jcfg, params)
    state = tx.init(params)
    update = jax.jit(tx.update)
    gen = torch.Generator().manual_seed(accum)
    flat_params = traverse_util.flatten_dict(params)
    for _ in range(2 * accum):  # two updates
        with torch.no_grad():
            for m in (tmodel, tenc):
                for p in m.parameters():
                    if p.requires_grad:
                        g = torch.randn(p.shape, generator=gen)
                        p.grad = g if p.grad is None else p.grad + g
        new = {("model",) + k: v for k, v in traverse_util.flatten_dict(flax_tree(tmodel, grads=True)).items()}
        new.update({("style_enc",) + k: v for k, v in traverse_util.flatten_dict(flax_tree(tenc, grads=True)).items()})
        if opt.micro % accum:  # the port holds the running sum; hand JAX this micro-step's part
            new = {k: v - prev[k] for k, v in new.items()}
        prev = new
        grads = traverse_util.unflatten_dict({k: new.get(k, np.zeros_like(np.asarray(v))) for k, v in flat_params.items()})
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step()
    assert opt.updates == 2
    got = {("model",) + k: v for k, v in traverse_util.flatten_dict(flax_tree(tmodel)).items()}
    got.update({("style_enc",) + k: v for k, v in traverse_util.flatten_dict(flax_tree(tenc)).items()})
    want = traverse_util.flatten_dict(params)
    moved = 0
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(want[k]), atol=1e-6, rtol=0, err_msg=str(k))
        moved += not np.array_equal(v, flat_params[k])
    assert moved > 0


@pytest.mark.parametrize("kw", [dict(scheduler="Warmup", warm_iter=7), dict(scheduler="Warmup", warm_iter=0),
                                dict(scheduler="WarmupThenDecay", warm_iter=5, cos_max_iter=40, min_lr_ratio=0.1),
                                dict(scheduler="none")])
def test_schedules_equal_jax(kw):
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.train.scheduler import make_schedule as jsched
    from msmd_tpu_torch.train.scheduler import make_schedule

    kw = dict(kw, lr=3e-4)
    js, ts = jsched(JCfg(**kw)), make_schedule(MSMDConfig(**kw))
    got = np.array([ts(step) for step in range(50)], np.float32)
    want = np.array([js(jnp.int32(step)) for step in range(50)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if kw["scheduler"] == "Warmup":
        np.testing.assert_array_equal(got, want)


def _train_path(**kw):
    from msmd_tpu_torch.measure import build_train_path

    from test_torch_common import TINY_AUDIO

    return build_train_path("cpu", cfg_kw=_tiny(**kw), audio_kw=TINY_AUDIO)


def test_frozen_parameters_do_not_move():
    path = _train_path(warm_iter=0, fused_ffn_train=True)
    model = path["model"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(path["cfg"]).items()}
    for _ in range(2):
        tloop.train_step(path["cfg"], model, path["style_enc"], path["opt"], batch, path["generator"],
                         path["host_generator"])
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith("audio_encoder.") for n in frozen)
    assert all(torch.equal(model.get_parameter(n), before[n]) for n in frozen)
    assert not torch.equal(model.get_parameter("denoising_net.person_proj.weight"), before[
        "denoising_net.person_proj.weight"])
    assert not torch.equal(model.get_parameter("audio_encoder.encoder.layers.1.q_proj.weight"), before[
        "audio_encoder.encoder.layers.1.q_proj.weight"]) or path["cfg"].audio_model == "hubert"


def test_overfit_lowers_the_loss():
    path = _train_path(use_cross_style=False, trunc_prob1=0.0, trunc_prob2=0.0, do_ignore_cfg=True, lr=5e-4,
                       warm_iter=1, fused_ffn_train=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(path["cfg"], seed=3).items()}
    losses = []
    for _ in range(20):
        path["generator"].manual_seed(42)  # the same noise and timesteps every step
        m = tloop.train_step(path["cfg"], path["model"], path["style_enc"], path["opt"], batch, path["generator"],
                             path["host_generator"])
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]


def test_eval_step_is_deterministic_given_the_generator():
    path = _train_path(fused_ffn_train=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(path["cfg"]).items()}
    run = lambda: tloop.eval_step(path["cfg"], path["model"], path["style_enc"], batch,
                                  torch.Generator().manual_seed(9))
    a, b = run(), run()
    assert set(a) == set(b) and all(float(a[k]) == float(b[k]) for k in a)
