"""Guided inpainting (``sample_with_guide``) equals the JAX package's,
with the same weights, inputs and noise.

- ``sample_with_guide`` in both CFG modes (incremental keeps two entries
  at equal scales, independent three): f32 atol 1e-4; bf16 (the port's
  decoder through K6's wrapper, JAX through its XLA decoder with K6 in
  interpret mode) as ``test_torch_sample.py`` bounds bf16 ``sample``:
  mean |err| <= 1.5e-2 of mean |ref|, max |err| <= 3e-2 of max |ref|, 4e-2
  with the dynamic threshold. Under ``MSMD_ATTN_KERNEL=1`` and
  ``MSMD_FUSED_TAIL=1`` (JAX) against ``attn_kernel`` and ``fused_tail``
  (the port), the same bounds, with spies showing that JAX ran K8 and K9.

The style-basis sampler, the training forward with ``keep_separate`` and
the kernel routes of a guided window are in ``test_torch_separate.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.models.diffusion import sample_with_guide as jguide
from msmd_tpu_torch.models import transformer as ttr
from msmd_tpu_torch.models.diffusion import sample_with_guide

from test_torch_common import build_msmd_pair, counting_spy

GUIDE_IDX = np.array([0, 3, 6])
B = 4  # one batch size for every JAX model: each new shape costs JAX seconds of compiling on the CPU


def _inputs(seed, B, kw):
    rs = np.random.RandomState(seed)
    n = kw["n_motions"]
    return dict(
        feat=rs.randn(B, n, kw["feature_dim"]).astype(np.float32),
        shape=(rs.randn(B, 100) * 0.3).astype(np.float32),
        style=rs.randn(B, kw["d_style"]).astype(np.float32),
        mT=rs.randn(B, n, 67).astype(np.float32),
        noise=rs.randn(kw["n_diff_steps"], B, n, 67).astype(np.float32),
        gvals=rs.randn(len(GUIDE_IDX), 67).astype(np.float32),
    )


def _check_bf16(got, want, dyn):
    err = np.abs(got - want)
    assert err.mean() / np.abs(want).mean() <= 1.5e-2, err.mean()
    assert err.max() / np.abs(want).max() <= (3e-2 if dyn is None else 4e-2), err.max()


def _guided_pair(dtype, mode, dyn, seed, port_kw=None):
    jm, jv, tm, kw = build_msmd_pair(dtype, seed=seed, batch=B, cfg_mode=mode)
    a = _inputs(seed + 1, B, kw)
    want, _, _ = jguide(jm, jv, jax.random.PRNGKey(0), jnp.asarray(a["feat"]), jnp.asarray(a["shape"]),
                        style_feat=jnp.asarray(a["style"]), motion_at_T=jnp.asarray(a["mT"]),
                        noise_override=jnp.asarray(a["noise"]), dynamic_threshold=dyn,
                        guidance_indice=jnp.asarray(GUIDE_IDX), guidance_values=jnp.asarray(a["gvals"]))
    got, got_T, _ = sample_with_guide(tm, a["feat"], a["shape"], style_feat=a["style"], motion_at_T=a["mT"],
                                      noise_override=a["noise"], dynamic_threshold=dyn, device="cpu",
                                      guidance_indice=GUIDE_IDX, guidance_values=a["gvals"], **(port_kw or {}))
    np.testing.assert_array_equal(got_T.numpy(), a["mT"])
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape == (B, kw["n_motions"], 67)
    return got.numpy(), want


@pytest.mark.parametrize("dtype,mode,dyn", [
    ("float32", "incremental", None), ("float32", "independent", (0, 1, 4)),
    ("bfloat16", "incremental", None), ("bfloat16", "independent", (0, 1, 4)),
])
def test_sample_with_guide_matches_jax(dtype, mode, dyn):
    got, want = _guided_pair(dtype, mode, dyn, seed=21)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        _check_bf16(got, want, dyn)


@pytest.mark.parametrize("env,port_kw,spied", [
    ("MSMD_ATTN_KERNEL", {"attn_kernel": True}, ("attn_kernel", "attention_middle")),
    ("MSMD_FUSED_TAIL", {"fused_tail": True}, ("layer_tail_kernel", "fused_layer_tail")),
])
def test_sample_with_guide_opt_in_kernels_match_jax(monkeypatch, env, port_kw, spied):
    """JAX's opt-in kernels against the port's options, on a guided bf16
    window at Be = 8, where JAX's tile gates open."""
    import importlib

    monkeypatch.setenv(env, "1")
    calls = {}
    counting_spy(monkeypatch, importlib.import_module("msmd_tpu.ops.pallas." + spied[0]), spied[1], calls, "jax")
    counting_spy(monkeypatch, ttr, spied[1], calls, "port")
    got, want = _guided_pair("bfloat16", "incremental", None, seed=23, port_kw=port_kw)
    assert calls["jax"] > 0 and calls["port"] == 2 * 4  # layers x steps
    _check_bf16(got, want, None)
