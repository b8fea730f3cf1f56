"""The port's modules equal the Flax modules at f32 with the same
weights (atol 1e-5, rtol 1e-4): transformer layers, the audio encoder,
the style encoder's mean and the denoiser forward."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from msmd_tpu.models import transformer as jtr
from msmd_tpu.models.diffusion import MSMD as JMSMD
from msmd_tpu.models.style_encoder import StyleEncoderVAE2 as JVAE2
from msmd_tpu_torch.interop import load_flax_params
from msmd_tpu_torch.models import transformer as ttr
from msmd_tpu_torch.models.style_encoder import StyleEncoderVAE2

from test_torch_common import build_msmd_pair, np_params

TOL = dict(atol=1e-5, rtol=1e-4)
rs = np.random.RandomState(0)


def _t(a):
    return torch.as_tensor(a)


def test_decoder_stack_with_cache_and_identity_band():
    F, H, L, lq = 32, 4, 2, 12
    x = rs.randn(3, lq, F).astype(np.float32)
    mem = rs.randn(3, lq - 1, F).astype(np.float32)
    jdec = jtr.TransformerDecoder(L, F, H, 64)
    v = jdec.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mem))
    tdec = load_flax_params(ttr.TransformerDecoder(L, F, H, 64), np_params(v))
    jkv = jdec.apply(v, jnp.asarray(mem), method=jtr.TransformerDecoder.cache_memory)
    tkv = tdec.cache_memory(_t(mem))
    for (jk, jv_), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv_), **TOL)
    want = jdec.apply(v, jnp.asarray(x), None, None, True, memory_kv=jkv, cross_identity_band=True)
    got = tdec(_t(x), memory_kv=tkv, cross_identity_band=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # the masked softmax path with a banded memory mask
    from msmd_tpu.ops.seq import alignment_mask

    mask = alignment_mask(4, lq - 5, 2)
    want = jdec.apply(v, jnp.asarray(x), jnp.asarray(mem), mask, True)
    got = tdec(_t(x), _t(mem), torch.as_tensor(np.asarray(mask)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_encoder_layer():
    x = rs.randn(2, 9, 32).astype(np.float32)
    jl = jtr.TransformerEncoderLayer(32, 4, 48)
    v = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tl = load_flax_params(ttr.TransformerEncoderLayer(32, 4, 48), np_params(v))
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(), np.asarray(jl.apply(v, jnp.asarray(x))), **TOL)


def test_style_encoder_mean_and_sample():
    clip = rs.randn(2, 20, 67).astype(np.float32)
    jenc = JVAE2(d_style=16, conv_feature_dim=64)
    v = jenc.init({"params": jax.random.PRNGKey(2), "style": jax.random.PRNGKey(3)}, jnp.asarray(clip))
    tenc = load_flax_params(StyleEncoderVAE2(16, conv_feature_dim=64), np_params(v))
    want = jenc.apply(v, jnp.asarray(clip), method=JVAE2.encode_mean)
    np.testing.assert_allclose(tenc.encode_mean(_t(clip)).detach().numpy(), np.asarray(want), **TOL)
    _, mu, logvar = jenc.apply(v, jnp.asarray(clip), rngs={"style": jax.random.PRNGKey(4)})
    eps = rs.randn(2, 16).astype(np.float32)
    want = np.asarray(mu) + eps * np.exp(0.5 * np.asarray(logvar))
    np.testing.assert_allclose(tenc.sample(_t(clip), eps=_t(eps)).detach().numpy(), want, **TOL)


def test_audio_encoder_and_denoiser_forward():
    jm, jv, tm, kw = build_msmd_pair("float32", seed=3)
    B, n, P, Fd = 4, kw["n_motions"], kw["n_prev_motions"], kw["feature_dim"]
    audio = (rs.randn(B, 5120) * 0.1).astype(np.float32)
    want = jm.apply(jv, jnp.asarray(audio), method=JMSMD.extract_audio_feature)
    got = tm.extract_audio_feature(_t(audio))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    args = [rs.randn(B, n, 67), rs.randn(B, n, Fd), rs.randn(B, 1, 100 + 16), rs.randn(B, 1, 16),
            rs.randn(B, P, 67), rs.randn(B, P, Fd)]
    args = [a.astype(np.float32) for a in args]
    step = np.array([1, 2, 3, 4])
    ind = np.ones((B, n), np.float32)
    ind[:, -2:] = 0
    want = jm.apply(jv, *map(jnp.asarray, args), jnp.asarray(step), jnp.asarray(ind), method=JMSMD.denoise)
    got = tm.denoising_net(*map(_t, args), _t(step), _t(ind))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # cached memory K/V and the precomputed step-embedding table give the same result
    kv = tm.denoising_net.cache_memory_kv(_t(args[5]), _t(args[1]))
    table = tm.denoising_net.precompute_step_emb()
    got = tm.denoising_net(*map(_t, args), _t(step), _t(ind), memory_kv=kv, step_emb_table=table)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
