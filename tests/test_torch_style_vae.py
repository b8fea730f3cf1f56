"""The port's style encoders (``msmd_tpu_torch/models/style_encoder.py``)
against the JAX package's on the CPU:

- ``StyleEncoderVAE`` (ReLU head, output 4 d_style, ReLU after the last
  conv) and ``StyleEncoderVAE2`` with the JAX weights carried across by
  ``load_flax_params``: ``forward`` on the eps JAX drew, ``sample`` and
  ``encode_mean``, f32, atol 1e-5 (another summation order);
- the factory: "vae2", "vae" and a refused name, in both packages;
- the "vae" configuration: its z is 2 d_style wide where the denoiser
  takes d_style. JAX builds the pair and fails in its first train step and
  in ``sample``; the port's ``Trainer`` and ``load_model`` refuse it with a
  ``ValueError`` naming both widths;
- K8 inside the encoders: ``attn_kernel=True`` against JAX's encoder under
  ``MSMD_ATTN_KERNEL=1`` at a shape JAX's gate takes (B 2, lq 12, 64 wide,
  8 heads of 8), f32 atol 1e-5 and bf16 max |err| / max |ref| <= 2e-2, a
  spy showing that JAX ran ``attention_middle`` (interpret mode) and the
  port its K8 wrapper; past ``MAX_LQ`` rows the port's gate routes around
  the wrapper.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.models import style_encoder as jse
from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
from msmd_tpu_torch.interop import load_flax_params
from msmd_tpu_torch.models import style_encoder as tse
from msmd_tpu_torch.models import transformer as ttr
from msmd_tpu_torch.ops.kernels import attn as tattn

from test_torch_common import TINY_AUDIO, counting_spy, np_params, rel_err, tiny_cfg_kwargs

D_STYLE = 16


def _pair(kind, width=64, dtype="float32", T=12, seed=0):
    """(JAX encoder, its variables, the port's encoder with its weights)."""
    jcls = {"vae": jse.StyleEncoderVAE, "vae2": jse.StyleEncoderVAE2}[kind]
    tcls = {"vae": tse.StyleEncoderVAE, "vae2": tse.StyleEncoderVAE2}[kind]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jenc = jcls(d_style=D_STYLE, conv_feature_dim=width, dtype=jdt)
    variables = jenc.init({"params": jax.random.PRNGKey(seed), "style": jax.random.PRNGKey(seed + 1)},
                          np.zeros((1, T, 67), np.float32))
    tenc = load_flax_params(tcls(d_style=D_STYLE, conv_feature_dim=width, dtype=tdt), np_params(variables))
    return jenc, variables, tenc.eval()


def _clip(B=2, T=12, seed=3):
    return np.random.RandomState(seed).randn(B, T, 67).astype(np.float32)


@pytest.mark.parametrize("kind", ["vae", "vae2"])
def test_forward_sample_and_mean_match_jax(kind):
    jenc, variables, tenc = _pair(kind)
    x = _clip()
    z, mu, logvar = jenc.apply(variables, jnp.asarray(x), rngs={"style": jax.random.PRNGKey(5)})
    eps = (np.asarray(z) - np.asarray(mu)) / np.exp(0.5 * np.asarray(logvar))  # the draw JAX made
    width = D_STYLE * (2 if kind == "vae" else 1)
    assert tenc.z_dim == width and z.shape == (2, width)
    with torch.no_grad():
        got = tenc(torch.as_tensor(x), eps=torch.as_tensor(eps))
        for g, w in zip(got, (z, mu, logvar)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        js = jenc.apply(variables, jnp.asarray(x), rngs={"style": jax.random.PRNGKey(6)}, method=jenc.sample)
        eps_s = (np.asarray(js) - np.asarray(mu)) / np.exp(0.5 * np.asarray(logvar))
        np.testing.assert_allclose(tenc.sample(torch.as_tensor(x), eps=torch.as_tensor(eps_s)).numpy(),
                                   np.asarray(js), atol=1e-5)
        np.testing.assert_allclose(tenc.encode_mean(torch.as_tensor(x)).numpy(),
                                   np.asarray(jenc.apply(variables, jnp.asarray(x), method=jenc.encode_mean)),
                                   atol=1e-5)
        # a generator's draw: the same formula over another eps
        g = torch.Generator().manual_seed(0)
        zg, mug, lvg = tenc(torch.as_tensor(x), generator=g)
        assert zg.shape == (2, width) and torch.isfinite(zg).all() and not torch.equal(zg, mug)


def test_reference_checkpoint_names_load_the_vae():
    """The reference ``.pt`` names of the VAE are VAE2's: the JAX package's
    export of a VAE tree, read back by the port's ``interop.py`` mapping,
    loads ``StyleEncoderVAE`` and gives JAX's posterior mean."""
    from msmd_tpu.interop.msmd_checkpoint import flax_to_reference_style_enc
    from msmd_tpu_torch.interop import reference_style_enc_to_flax

    jenc, variables, _ = _pair("vae")
    sd = flax_to_reference_style_enc(np_params(variables), conv_feature_dim=64)
    tenc = load_flax_params(tse.StyleEncoderVAE(d_style=D_STYLE, conv_feature_dim=64),
                            reference_style_enc_to_flax({k: np.asarray(v) for k, v in sd.items()})).eval()
    x = _clip(seed=9)
    with torch.no_grad():
        got = tenc.encode_mean(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jenc.apply(variables, jnp.asarray(x), method=jenc.encode_mean)),
                               atol=1e-5)


def test_vae_relu_head_gives_nonnegative_means():
    """The VAE's ReLU after the last conv leaves every (mu, logvar) entry
    of a mean-pool of non-negative values >= 0."""
    _, _, tenc = _pair("vae")
    with torch.no_grad():
        mu, logvar = tenc.encode(torch.as_tensor(_clip()))
    assert (mu >= 0).all() and (logvar >= 0).all()
    assert tenc.output_size == 4 * D_STYLE


def test_factory_matches_jax():
    cfg = MSMDConfig(**tiny_cfg_kwargs())
    from msmd_tpu.config import MSMDConfig as JCfg

    jcfg = JCfg(**tiny_cfg_kwargs())
    for style, cls in (("vae2", tse.StyleEncoderVAE2), ("vae", tse.StyleEncoderVAE)):
        enc = tse.get_style_encoder(cfg, style)
        jenc = jse.get_style_encoder(jcfg, style)
        assert type(enc) is cls and type(jenc).__name__ == cls.__name__
        assert enc.output_size == jenc.output_size and enc.conv_feature_dim == jenc.conv_feature_dim == 512
    assert tse.get_style_encoder(cfg, dtype=torch.bfloat16, input_dim=54).dtype == torch.bfloat16
    for get, c in ((tse.get_style_encoder, cfg), (jse.get_style_encoder, jcfg)):
        with pytest.raises(ValueError, match="not recognized"):
            get(c, "vae3")


def test_vae_configuration_refused_as_jax_fails(tmp_path):
    """JAX's MSMD is built for d_style (``null_style_feat``, the init from
    (B, d_style) zeros), and the VAE's z is 2 d_style wide: JAX fails in a
    train step and in ``sample``; the port refuses the pair when built."""
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.models.audio import AudioEncoderConfig as JAudio
    from msmd_tpu.models.diffusion import get_diffusion_model as jget
    from msmd_tpu.models.diffusion import sample as jsample
    from msmd_tpu.train.trainer import Trainer as JTrainer
    from msmd_tpu_torch.inference_lib import load_model
    from msmd_tpu_torch.models.diffusion import get_diffusion_model
    from msmd_tpu_torch.train.checkpoint import save_reference_pt
    from msmd_tpu_torch.train.trainer import Trainer

    kw = tiny_cfg_kwargs(style_enc_model_style="vae", batch_size=2)
    jcfg = JCfg(**kw)
    jtr = JTrainer(jcfg, tmp_path / "jax", audio_config=JAudio(**TINY_AUDIO), use_mesh=False)
    rs, B = np.random.RandomState(0), 2
    batch = {f"{k}_{i}": v for i in range(2) for k, v in (
        ("audio", rs.randn(B, jcfg.n_audio_samples).astype(np.float32)),
        ("motion", rs.randn(B, jcfg.n_motions, 67).astype(np.float32)),
        ("shape", rs.randn(B, jcfg.n_motions, 100).astype(np.float32)))}
    with pytest.raises(ValueError, match="broadcasting"):
        jtr.train_step(jtr.state, batch, jax.random.PRNGKey(0))
    jmodel = jget(jcfg, audio_config=JAudio(**TINY_AUDIO))
    jvars = jmodel.init({"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
                        jnp.zeros((1, jcfg.n_motions, 67)), jnp.zeros((1, jcfg.n_audio_samples)),
                        jnp.zeros((1, 100)), jnp.zeros((1, jcfg.d_style)), deterministic=True)
    with pytest.raises(TypeError):
        jsample(jmodel, jvars, jax.random.PRNGKey(2), jnp.zeros((1, jcfg.n_motions, jcfg.feature_dim)),
                jnp.zeros((1, 100)), jnp.zeros((1, 2 * jcfg.d_style)))

    cfg = MSMDConfig(**kw)
    audio = AudioEncoderConfig(**TINY_AUDIO)
    with pytest.raises(ValueError, match=r"width 32.*d_style = 16"):
        Trainer(cfg, tmp_path / "torch", audio_config=audio, device="cpu")
    exp_dir = tmp_path / "exps" / "DPT" / "m"
    cfg = cfg.replace(audio_encoder_config=dataclasses.asdict(audio))
    cfg.save_args_json(exp_dir)
    save_reference_pt(exp_dir, cfg, get_diffusion_model(cfg, audio_config=audio, device="cpu"),
                      tse.get_style_encoder(cfg, "vae2"), 1)
    with pytest.raises(ValueError, match=r"'vae' gives a z of width 32"):
        load_model(tmp_path / "exps", "m", "0000001", device="cpu")


@pytest.mark.parametrize("kind", ["vae", "vae2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_kernel_in_the_encoder_matches_jax(monkeypatch, kind, dtype):
    from msmd_tpu.ops.pallas import attn_kernel

    monkeypatch.setenv("MSMD_ATTN_KERNEL", "1")
    jenc, variables, tenc = _pair(kind, dtype=dtype, seed=4)
    x = _clip(seed=8)
    calls = {}
    counting_spy(monkeypatch, attn_kernel, "attention_middle", calls, "jax")
    counting_spy(monkeypatch, ttr, "attention_middle", calls, "port")
    want = jenc.apply(variables, jnp.asarray(x), method=jenc.encode_mean)
    with torch.no_grad():
        got = tenc.encode_mean(torch.as_tensor(x), attn_kernel=True)
        plain_route = tenc.encode_mean(torch.as_tensor(x))
    assert calls == {"jax": 1, "port": 1}
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), plain_route.numpy(), atol=1e-6)
    else:
        assert rel_err(got.float(), want) <= 2e-2


def test_attn_kernel_gate_routes_long_clips_around_k8(monkeypatch):
    """Past ``MAX_LQ`` rows ``attn_kernel_takes`` closes: the encoder takes
    the plain attention, and the K8 wrapper is not called."""
    calls = {}
    counting_spy(monkeypatch, ttr, "attention_middle", calls, "port")
    _, _, tenc = _pair("vae2", T=8)
    assert tattn.attn_kernel_takes(1, tattn.MAX_LQ, 64, 8) and not tattn.attn_kernel_takes(1, tattn.MAX_LQ + 1, 64, 8)
    with torch.no_grad():
        for T, n in ((tattn.MAX_LQ, 1), (tattn.MAX_LQ + 1, 1)):
            x = torch.as_tensor(_clip(B=1, T=T, seed=T))
            got = tenc.encode_mean(x, attn_kernel=True)
            np.testing.assert_allclose(got.numpy(), tenc.encode_mean(x).numpy(), atol=1e-6)
            assert calls["port"] == n
