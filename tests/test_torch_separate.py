"""The style-basis sampler (``sample_separate``) and the training forward
with ``keep_separate`` equal the JAX package's, with the same weights,
inputs and noise; and a guided window's routes, counted by kernel.

- ``sample_separate``: all six outputs at f32, atol 1e-4, with and
  without ``alpha_t_modification`` and ``return_all_alpha``.
- ``MSMD.forward(keep_separate=True)``: all seven outputs at f32, atol
  1e-5, and its target is the recombination with alpha on all channels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.models.diffusion import sample_separate as jseparate
from msmd_tpu_torch.models import transformer as ttr
from msmd_tpu_torch.models.diffusion import sample_separate, sample_with_guide
from msmd_tpu_torch.ops.kernels import decoder as tdk
from msmd_tpu_torch.ops.kernels import sampler as tks

from test_torch_common import build_msmd_pair, counting_spy
from test_torch_guided import B, GUIDE_IDX, _inputs


@pytest.mark.parametrize("alpha_mod,all_alpha", [(False, False), (True, True), (True, False)])
def test_sample_separate_matches_jax(alpha_mod, all_alpha):
    jm, jv, tm, kw = build_msmd_pair("float32", seed=31, batch=B)
    a = _inputs(32, B, kw)
    mod = (lambda al: al * 0.5 + 0.25) if alpha_mod else None
    want = jseparate(jm, jv, jax.random.PRNGKey(0), jnp.asarray(a["feat"]), jnp.asarray(a["shape"]),
                     style_feat=jnp.asarray(a["style"]), motion_at_T=jnp.asarray(a["mT"]),
                     noise_override=jnp.asarray(a["noise"]), alpha_t_modification=mod,
                     return_all_alpha=all_alpha)
    got = sample_separate(tm, a["feat"], a["shape"], style_feat=a["style"], motion_at_T=a["mT"],
                          noise_override=a["noise"], alpha_t_modification=mod, return_all_alpha=all_alpha,
                          device="cpu")
    assert len(got) == len(want) == 6
    n, T, K = kw["n_motions"], kw["n_diff_steps"], kw["num_of_basis"]
    shapes = [(B, n, 67), (B, n, 67), (B, n, kw["feature_dim"]), (B, n, 67), (B, n, 67),
              (T, B, n, K) if all_alpha else (B, n, K)]
    for i, (g, w, s) in enumerate(zip(got, want, shapes)):
        assert tuple(g.shape) == np.asarray(w).shape == s, i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=str(i))


def test_forward_keep_separate_matches_jax():
    jm, jv, tm, kw = build_msmd_pair("float32", seed=41, batch=B)
    rs = np.random.RandomState(42)
    n = kw["n_motions"]
    motion = rs.randn(B, n, 67).astype(np.float32)
    feat = rs.randn(B, n, kw["feature_dim"]).astype(np.float32)
    shape, style = rs.randn(B, 100).astype(np.float32), rs.randn(B, kw["d_style"]).astype(np.float32)
    step, noise = np.array([1, 2, 4, 3]), rs.randn(B, n, 67).astype(np.float32)
    want = jm.apply(jv, *map(jnp.asarray, (motion, feat, shape, style)), time_step=jnp.asarray(step),
                    train_with_cfg=False, keep_separate=True, deterministic=True, noise=jnp.asarray(noise))
    with torch.no_grad():
        got = tm(*map(torch.as_tensor, (motion, feat, shape, style)), time_step=torch.as_tensor(step),
                 train_with_cfg=False, train=False, noise=torch.as_tensor(noise), keep_separate=True)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=str(i))
    dynamic, static, alpha = got[4:]
    np.testing.assert_allclose(got[1].numpy(), (dynamic + (static * alpha[..., None]).sum(2)).numpy(), atol=1e-6)


@pytest.mark.parametrize("extra,want", [
    ({}, {"ffn": 8}),
    ({"attn_kernel": True}, {"ffn": 8, "attn": 8}),
    ({"fused_tail": True}, {"tail": 8}),
    ({"fused_tail": True, "attn_kernel": True}, {"tail": 8}),
])
def test_guided_window_routes(monkeypatch, extra, want):
    """A bf16 guided window calls K6's wrapper once per layer and step, and
    K1, K3, K4, K8 and K9 never; ``attn_kernel`` adds K8 as often;
    ``fused_tail`` calls K9 as often and K6 and K8 never. ``sample_separate``
    calls none of them."""
    calls = {}
    for module, name, key in ((tdk, "fused_decoder_forward", "decoder"), (tks, "fused_sampler_scan", "scan"),
                              (tks, "fused_sampler_step", "step"), (ttr, "fused_ffn_ln", "ffn"),
                              (ttr, "attention_middle", "attn"), (ttr, "fused_layer_tail", "tail")):
        counting_spy(monkeypatch, module, name, calls, key)
    _, _, tm, kw = build_msmd_pair("bfloat16", seed=51, batch=B)
    a = _inputs(52, 1, kw)  # batch 1, where without guidance the window would be one K3 call
    out, _, _ = sample_with_guide(tm, a["feat"], a["shape"], style_feat=a["style"], device="cpu",
                                  guidance_indice=GUIDE_IDX, guidance_values=a["gvals"], **extra)
    assert out.shape == (1, kw["n_motions"], 67) and bool(torch.isfinite(out).all())
    assert calls == {k: 0 for k in calls} | want  # 2 layers x 4 steps
    for k in calls:
        calls[k] = 0
    outs = sample_separate(tm, a["feat"], a["shape"], style_feat=a["style"], device="cpu")
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)
    assert not any(calls.values())
