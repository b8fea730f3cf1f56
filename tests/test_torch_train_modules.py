"""The port's training-mode modules against the JAX package on the CPU, at
the tiny geometry of ``test_torch_common.py``:

- ``MSMD.forward`` (the training forward) with fixed timesteps and noise
  and no CFG drop, in eval mode, for clip 0 (learned start features) and
  clip 1 (a given previous window): eps and target, f32 atol 1e-4;
- the VAE2 ``(z, mu, logvar)`` with a given eps: atol 1e-5;
- SpecAugment: span layout and the statistics of the masked-frame count
  against the JAX sampler's (4 sigma);
- the freezing policy: the same parameters train as under JAX's
  ``trainable_mask``, for hubert and wav2vec2;
- the decoder layer's K7 route, at dropout 0, equals its plain FFN block.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

from msmd_tpu_torch.interop import flax_tree, load_flax_params

from test_torch_common import build_msmd_pair, np_params


def _forward_inputs(kw, B=2, seed=0):
    rs = np.random.RandomState(seed)
    n, P, F = kw["n_motions"], kw["n_prev_motions"], kw["feature_dim"]
    from msmd_tpu_torch.config import MSMDConfig

    L_a = MSMDConfig(**kw).n_audio_samples
    return dict(
        motion=rs.randn(B, n, 67).astype(np.float32),
        audio=rs.randn(B, L_a).astype(np.float32),
        shape=rs.randn(B, 100).astype(np.float32),
        style=rs.randn(B, kw["d_style"]).astype(np.float32),
        t=np.array([1, kw["n_diff_steps"]], np.int32)[:B],
        noise=rs.randn(B, n, 67).astype(np.float32),
        indicator=(np.arange(n)[None, :] < np.array([[n - 3], [n]])[:B]).astype(np.float32),
        prev_motion=rs.randn(B, P, 67).astype(np.float32),
        prev_audio=rs.randn(B, P, F).astype(np.float32),
    )


@pytest.mark.parametrize("clip", [0, 1])
def test_msmd_training_forward_matches_jax(clip):
    jmodel, variables, tmodel, kw = build_msmd_pair(batch=2)
    x = _forward_inputs(kw)
    prev = {}
    if clip == 1:
        prev = dict(prev_motion_feat=x["prev_motion"], prev_audio_feat=x["prev_audio"])
    jeps, jtarget, jmotion, jfeat = jmodel.apply(
        variables, x["motion"], x["audio"], x["shape"], x["style"], time_step=jnp.asarray(x["t"]),
        indicator=x["indicator"], train_with_cfg=False, deterministic=True, noise=x["noise"],
        rngs={"diffusion": jax.random.PRNGKey(3)}, **prev)
    t = lambda a: torch.from_numpy(a)
    eps, target, motion, feat = tmodel(t(x["motion"]), t(x["audio"]), t(x["shape"]), t(x["style"]),
                                       time_step=t(x["t"]).long(), indicator=t(x["indicator"]), train_with_cfg=False,
                                       train=False, noise=t(x["noise"]),
                                       **{k: t(v) for k, v in prev.items()})
    np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), atol=1e-6)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat), atol=1e-4)
    np.testing.assert_allclose(target.detach().numpy(), np.asarray(jtarget), atol=1e-4)
    assert target.shape == (2, kw["n_prev_motions"] + kw["n_motions"], 67)


def test_msmd_training_forward_draws_from_the_generator():
    """Without the hooks: the same generator state gives the same draws,
    train mode differs from eval mode, and the CFG drop can reach the
    null embeddings."""
    _, _, tmodel, kw = build_msmd_pair(batch=2)
    x = _forward_inputs(kw)
    args = [torch.from_numpy(x[k]) for k in ("motion", "audio", "shape", "style")]
    run = lambda seed, train: tmodel(*args, generator=torch.Generator().manual_seed(seed), train=train)[:2]
    a, b = run(5, True), run(5, True)
    torch.testing.assert_close(a[0], b[0])
    torch.testing.assert_close(a[1], b[1])
    c = run(5, False)
    assert not torch.allclose(a[1], c[1])
    loss = sum(run(s, True)[1].square().mean() for s in range(6))
    loss.backward()
    assert tmodel.null_style_feat.grad is not None and float(tmodel.null_style_feat.grad.abs().sum()) > 0


def test_vae2_matches_jax():
    from msmd_tpu.models.style_encoder import StyleEncoderVAE2 as JVAE2
    from msmd_tpu_torch.models.style_encoder import StyleEncoderVAE2

    jenc = JVAE2(d_style=16)
    rs = np.random.RandomState(1)
    clip = rs.randn(3, 20, 67).astype(np.float32)
    variables = jenc.init({"params": jax.random.PRNGKey(0), "style": jax.random.PRNGKey(1)}, clip)
    z_j, mu_j, lv_j = jenc.apply(variables, clip, rngs={"style": jax.random.PRNGKey(2)})
    eps = (np.asarray(z_j) - np.asarray(mu_j)) / np.exp(0.5 * np.asarray(lv_j))
    tenc = load_flax_params(StyleEncoderVAE2(d_style=16), np_params(variables))
    z, mu, lv = tenc(torch.from_numpy(clip), eps=torch.from_numpy(eps.astype(np.float32)))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(lv_j), atol=1e-5)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), atol=1e-5)
    # train mode: dropout draws from the generator, eval mode does not
    g = lambda: torch.Generator().manual_seed(4)
    z1 = tenc(torch.from_numpy(clip), g(), train=True)[1]
    z2 = tenc(torch.from_numpy(clip), g(), train=True)[1]
    torch.testing.assert_close(z1, z2)
    assert not torch.allclose(z1, mu)


def test_spec_augment_spans_match_jax_statistics():
    from msmd_tpu.models.audio import sample_time_masks as jmasks
    from msmd_tpu_torch.models.audio import sample_time_masks

    B, L, p, length = 4000, 200, 0.05, 10
    port = sample_time_masks(torch.Generator().manual_seed(0), B, L, p, length).numpy()
    ref = np.asarray(jmasks(jax.random.PRNGKey(0), B, L, p, length))
    assert port.shape == ref.shape == (B, L) and port.dtype == bool
    for m in (port, ref):
        counts = m.sum(1)
        assert counts.min() >= length and counts.max() <= 2 * length  # two spans of 10
        assert not m[:, L - 1].any()  # starts lie in [0, L - length)
    c_port, c_ref = port.sum(1), ref.sum(1)
    se = np.sqrt(c_port.var() / B + c_ref.var() / B)
    assert abs(c_port.mean() - c_ref.mean()) <= 4 * se
    # every masked run is at least one span long, starts in [0, L - length)
    for row in port[:50]:
        edges = np.flatnonzero(np.diff(np.concatenate([[0], row.astype(int), [0]])))
        starts, ends = edges[0::2], edges[1::2]
        assert ((ends - starts) >= length).all() and (starts < L - length).all()
    pos = port.mean(0)
    assert pos[:L - length].min() > 0 and pos[L - 1] == 0.0


@pytest.mark.parametrize("audio_model", ["hubert", "wav2vec2"])
def test_freezing_policy_matches_jax(audio_model):
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.train.loop import trainable_mask
    from msmd_tpu_torch.config import MSMDConfig
    from msmd_tpu_torch.train.loop import trainable

    jmodel, variables, tmodel, kw = build_msmd_pair(batch=1)
    kw = dict(kw, audio_model=audio_model)
    jmask = trainable_mask(JCfg(**kw), {"model": np_params(variables)})["model"]
    want = {k: bool(v) for k, v in traverse_util.flatten_dict(jmask).items()}
    cfg = MSMDConfig(**kw)
    with torch.no_grad():
        for name, p in tmodel.named_parameters():
            p.fill_(1.0 if trainable(cfg, name) else 0.0)
    got = {k: bool(v.flat[0]) for k, v in traverse_util.flatten_dict(flax_tree(tmodel)).items()}
    assert got == want
    assert sum(not v for v in got.values()) > 0


def test_decoder_layer_k7_route_at_dropout_0_equals_the_ffn_block():
    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.models.transformer import TransformerDecoderLayer

    layer = init_params(TransformerDecoderLayer(32, 4, 64, dropout=0.0), 3)
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(1))
    mem = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(2))
    kv = layer.memory_kv(mem)
    rng = lambda: torch.Generator().manual_seed(7)
    fused = layer(x, memory_kv=kv, cross_identity_band=True, rng=rng(), fused_ffn_train=True)
    plain = layer(x, memory_kv=kv, cross_identity_band=True, rng=rng(), fused_ffn_train=False)
    torch.testing.assert_close(fused, plain, atol=1e-5, rtol=0)
    fused.square().sum().backward()
    assert layer.ffn.linear1.weight.grad is not None and layer.norm3.weight.grad is not None
