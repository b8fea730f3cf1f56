"""The port's whole sampler and windowed inference equal the JAX
package's, with the same weights, inputs and noise.

- f32 ``sample`` (plain modules on both sides): atol 1e-4.
- bf16 ``sample`` at batch 4: the port's decoder goes through the
  decoder kernel's wrapper (its plain version on the CPU) and JAX runs its
  Pallas kernel in interpret mode. The elementwise ops around the decoder
  (GELU, the style-basis sums) round to bf16 at other points in the two
  frameworks, and four DDPM steps carry those differences on: the mean
  error is about 0.8% of the mean |reference| at every seed tried. Max
  error over max |reference| <= 3e-2 without dynamic thresholding; with
  it the outputs are clamped near +-1, where one bf16 step is 7.8e-3, so
  the max error is held to 4e-2 of max |reference| (five such steps).
- f32 ``infer_coeffs``: two windows with a padded tail, atol 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from msmd_tpu.inference_lib import infer_coeffs as jinfer
from msmd_tpu.models.diffusion import sample as jsample
from msmd_tpu_torch.inference_lib import infer_coeffs
from msmd_tpu_torch.models.diffusion import sample
from msmd_tpu_torch.ops.kernels import decoder as tdk

from test_torch_common import build_msmd_pair


def _sample_inputs(seed, B, kw):
    rs = np.random.RandomState(seed)
    n = kw["n_motions"]
    feat = rs.randn(B, n, kw["feature_dim"]).astype(np.float32)
    shape = (rs.randn(B, 100) * 0.3).astype(np.float32)
    style = rs.randn(B, kw["d_style"]).astype(np.float32)
    mT = rs.randn(B, n, 67).astype(np.float32)
    nz = rs.randn(kw["n_diff_steps"], B, n, 67).astype(np.float32)
    ind = np.ones((B, n), np.float32)
    ind[:, -3:] = 0
    return feat, shape, style, mT, nz, ind


@pytest.mark.parametrize("dtype,dyn", [("float32", None), ("float32", (0, 1, 4)),
                                       ("bfloat16", None), ("bfloat16", (0, 1, 4))])
def test_sample_matches_jax(dtype, dyn):
    B = 4
    jm, jv, tm, kw = build_msmd_pair(dtype, seed=5)
    feat, shape, style, mT, nz, ind = _sample_inputs(6, B, kw)
    want, _, _ = jsample(jm, jv, jax.random.PRNGKey(0), *map(jnp.asarray, (feat, shape, style)),
                         motion_at_T=jnp.asarray(mT), noise_override=jnp.asarray(nz),
                         indicator=jnp.asarray(ind), dynamic_threshold=dyn)
    want = np.asarray(want).astype(np.float32)
    before = tdk.fused_decoder_forward.launches
    got, got_T, _ = sample(tm, feat, shape, style, motion_at_T=mT, noise_override=nz, indicator=ind,
                           dynamic_threshold=dyn, device="cpu")
    assert tdk.fused_decoder_forward.launches == before  # the plain version is no launch
    assert got.shape == want.shape == (B, kw["n_motions"], 67)
    np.testing.assert_array_equal(got_T.numpy(), mT)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    else:
        err = np.abs(got.numpy() - want)
        assert err.mean() / np.abs(want).mean() <= 1.5e-2, err.mean()
        assert err.max() / np.abs(want).max() <= (3e-2 if dyn is None else 4e-2), err.max()


def test_bf16_sample_takes_the_decoder_kernel_path(monkeypatch):
    """At bf16 every step's decoder stack goes through the kernel's
    wrapper, also below batch 5 (where JAX would take its batch-1 mega
    kernels); at f32 it never does."""
    calls = []
    real = tdk.fused_decoder_forward

    def spy(*a):
        calls.append(a[3].shape)
        return real(*a)

    monkeypatch.setattr(tdk, "fused_decoder_forward", spy)
    for dtype, B, want_calls in (("bfloat16", 1, 4), ("float32", 2, 0)):
        calls.clear()
        _, _, tm, kw = build_msmd_pair(dtype, seed=7, batch=B)
        feat, shape, style, *_ = _sample_inputs(8, B, kw)
        sample(tm, feat, shape, style, device="cpu")
        assert len(calls) == want_calls


def test_infer_coeffs_matches_jax():
    R = 2
    jm, jv, tm, kw = build_msmd_pair("float32", seed=9, batch=R)
    rs = np.random.RandomState(10)
    audio = (rs.randn(5120 + 3000) * 0.1).astype(np.float32)  # 2 windows, 4 padded frames
    shape = np.zeros((1, 100), np.float32)
    style = rs.randn(1, kw["d_style"]).astype(np.float32)
    mT = rs.randn(R, kw["n_motions"], 67).astype(np.float32)
    nz = rs.randn(kw["n_diff_steps"], R, kw["n_motions"], 67).astype(np.float32)
    want = jinfer(jm, jv, jax.random.PRNGKey(0), jnp.asarray(audio), jnp.asarray(shape),
                  style_feats=jnp.asarray(style), n_repetitions=R, motion_at_T=jnp.asarray(mT),
                  noise_override=jnp.asarray(nz))
    got = infer_coeffs(tm, audio, shape, style_feats=style, n_repetitions=R, motion_at_T=mT,
                       noise_override=nz, device="cpu")
    assert got.shape == (R, 12, 67) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("original_fps", [30, 25])
def test_load_style_clip_matches_jax(tmp_path, original_fps):
    import pickle

    from msmd_tpu.inference_lib import load_style_clip as jload
    from msmd_tpu_torch.inference_lib import load_style_clip

    rs = np.random.RandomState(11)
    pickle.dump(rs.randn(45, 64).astype(np.float32), open(tmp_path / "exp.pkl", "wb"))
    pickle.dump(rs.randn(45, 3).astype(np.float32), open(tmp_path / "head.pkl", "wb"))
    stats = {"exp_mean": rs.randn(64), "exp_std": rs.rand(64) + 0.5,
             "pose_mean": rs.randn(3), "pose_std": rs.rand(3) + 0.5}
    args = (tmp_path / "exp.pkl", tmp_path / "head.pkl", stats, original_fps)
    (m, s), (jm, js) = load_style_clip(*args), jload(*args)
    assert m.shape == jm.shape == (1, round(45 / original_fps * 25), 67)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(s, js)


def test_load_audio_16k_matches_jax(tmp_path):
    from scipy.io import wavfile

    from msmd_tpu.inference_lib import load_audio_16k as jload
    from msmd_tpu_torch.inference_lib import load_audio_16k

    rs = np.random.RandomState(12)
    wavfile.write(tmp_path / "a.wav", 22050, (rs.randn(22050, 2) * 3000).astype(np.int16))
    got, want = load_audio_16k(tmp_path / "a.wav"), jload(tmp_path / "a.wav")
    assert got.dtype == np.float32 and got.shape == want.shape == (16000,)
    np.testing.assert_array_equal(got, want)
