"""The port's checkpoint loader, ``MotionGenerator`` and CLI twin on an
experiment that the JAX package writes in the reference layout
(``args.json`` + ``checkpoints/iter_<it>.pt``), on the CPU.

- The loaded parameters equal those of the JAX ``load_model``, exactly.
- f32 ``infer_coeffs`` through both loaded models, with the same noise:
  atol 1e-4 (as ``test_torch_sample.py``).
"""

import dataclasses
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.config import MSMDConfig as JCfg
from msmd_tpu.inference_lib import infer_coeffs as jinfer
from msmd_tpu.inference_lib import load_model as jload_model
from msmd_tpu.models.audio import AudioEncoderConfig as JAudio
from msmd_tpu_torch.inference_lib import infer_coeffs, load_model
from msmd_tpu_torch.interop import load_flax_params
from msmd_tpu_torch.serving import MotionGenerator

from test_torch_common import TINY_AUDIO, np_params

ITER = "0000007"


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    from msmd_tpu.interop.msmd_checkpoint import flax_to_reference_msmd, flax_to_reference_style_enc
    from msmd_tpu.models.diffusion import get_diffusion_model
    from msmd_tpu.models.style_encoder import get_style_encoder
    from msmd_tpu.train.checkpoint import save_reference_pt
    from msmd_tpu.train.loop import init_models

    audio = JAudio(**TINY_AUDIO)
    cfg = JCfg(feature_dim=32, n_heads=4, n_layers=2, mlp_ratio=2, d_style=16, n_motions=8, n_prev_motions=4,
               n_diff_steps=3, num_of_basis=2, use_indicator=True, audio_encoder_config=dataclasses.asdict(audio))
    params = init_models(cfg, jax.random.PRNGKey(0), get_diffusion_model(cfg, audio_config=audio),
                         get_style_encoder(cfg, "vae2"))
    root = tmp_path_factory.mktemp("torch_serving_exp")
    exp_dir = root / "DPT" / "m"
    exp_dir.mkdir(parents=True)
    cfg.save_args_json(exp_dir)
    save_reference_pt(exp_dir, cfg, flax_to_reference_msmd(params["model"], cfg),
                      flax_to_reference_style_enc(params["style_enc"]), int(ITER))
    rs = np.random.RandomState(0)
    stats = {"exp_mean": rs.randn(64).astype(np.float32), "exp_std": (rs.rand(64) + 0.5).astype(np.float32),
             "pose_mean": rs.randn(3).astype(np.float32), "pose_std": (rs.rand(3) + 0.5).astype(np.float32)}
    return root, stats


def test_loaded_parameters_equal_jax(experiment):
    """Every leaf of the JAX ``load_model``'s params, loaded into a fresh
    port module, equals the parameter the port's loader set."""
    from msmd_tpu_torch.config import AudioEncoderConfig
    from msmd_tpu_torch.models.diffusion import get_diffusion_model
    from msmd_tpu_torch.models.style_encoder import get_style_encoder

    root, _ = experiment
    _, _, jmv, jsv, _ = jload_model(root, "m", ITER)
    model, style_enc, cfg = load_model(root, "m", ITER, device="cpu")
    assert model.dtype == torch.float32 and next(model.parameters()).device.type == "cpu"
    fresh_model = get_diffusion_model(cfg, audio_config=AudioEncoderConfig(**TINY_AUDIO), device="cpu")
    for mod, fresh, jvars in ((model, fresh_model, jmv), (style_enc, get_style_encoder(cfg), jsv)):
        want = dict(load_flax_params(fresh, np_params(jvars)).named_parameters())
        got = dict(mod.named_parameters())
        assert got.keys() == want.keys()
        for name in got:
            assert torch.equal(got[name], want[name]), name


def test_loaded_models_infer_the_same_coefficients(experiment):
    root, _ = experiment
    jm, _, jmv, _, _ = jload_model(root, "m", ITER)
    model, _, cfg = load_model(root, "m", ITER, device="cpu")
    rs = np.random.RandomState(1)
    audio = (rs.randn(5120 + 2000) * 0.1).astype(np.float32)  # two windows
    style = rs.randn(1, cfg.d_style).astype(np.float32)
    mT = rs.randn(1, cfg.n_motions, 67).astype(np.float32)
    nz = rs.randn(cfg.n_diff_steps, 1, cfg.n_motions, 67).astype(np.float32)
    shape = np.zeros((1, 100), np.float32)
    want = jinfer(jm, jmv, jax.random.PRNGKey(0), jnp.asarray(audio), jnp.asarray(shape),
                  style_feats=jnp.asarray(style), motion_at_T=jnp.asarray(mT), noise_override=jnp.asarray(nz))
    got = infer_coeffs(model, audio, shape, style_feats=style, motion_at_T=mT, noise_override=nz, device="cpu")
    assert got.shape == np.asarray(want).shape == (1, 11, 67)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_missing_iteration_lists_the_available_ones(experiment):
    root, _ = experiment
    with pytest.raises(FileNotFoundError, match=r"iter_0000099\.pt.*available: \['iter_0000007\.pt'\]"):
        load_model(root, "m", "0000099", device="cpu")


def test_motion_generator_is_deterministic_per_seed(experiment):
    root, stats = experiment
    gen = MotionGenerator.from_experiment(root, "m", ITER, stats, device="cpu")
    gen.warmup(max_seconds=1.0)
    rs = np.random.RandomState(2)
    audio = rs.randn(16000).astype(np.float32) * 0.1  # 1 s -> 25 frames
    style = rs.randn(120, 67).astype(np.float32)
    exp_a, rot_a = gen.generate(audio, style, n_repetitions=2, seed=3)
    exp_b, rot_b = gen.generate(audio, style, n_repetitions=2, seed=3)
    exp_c, _ = gen.generate(audio, style, n_repetitions=2, seed=4)
    assert exp_a.shape == (2, 25, 64) and rot_a.shape == (2, 25, 3)
    assert np.isfinite(exp_a).all() and np.isfinite(rot_a).all()
    np.testing.assert_array_equal(exp_a, exp_b)
    np.testing.assert_array_equal(rot_a, rot_b)
    assert not np.allclose(exp_a, exp_c)


@pytest.mark.parametrize("batch_seeds", [False, True])
def test_cli_writes_where_the_jax_cli_writes(experiment, tmp_path, batch_seeds):
    from scipy.io import wavfile

    from msmd_tpu_torch.inference import main

    root, stats = experiment
    rs = np.random.RandomState(3)
    for name, arr in (("style_exp.pkl", rs.randn(120, 64)), ("style_head.pkl", rs.randn(120, 3) * 10),
                      ("coef_stats.pkl", stats)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(arr.astype(np.float32) if isinstance(arr, np.ndarray) else arr, f)
    wavfile.write(tmp_path / "speech.wav", 16000, (rs.randn(24000) * 0.1).astype(np.float32))
    out = tmp_path / "out"
    main(["--model_root", str(root), "--model_name", "m", "--model_iter", ITER,
          "--style_clip_exp_code_path", str(tmp_path / "style_exp.pkl"),
          "--style_clip_head_rot_path", str(tmp_path / "style_head.pkl"),
          "--audio_clip", str(tmp_path / "speech.wav"), "--coef_dict_path", str(tmp_path / "coef_stats.pkl"),
          "--output_dir", str(out), "--versions_of_render", "2", "--device", "cpu"]
         + (["--batch_seeds"] if batch_seeds else []))
    temp = out / f"m_iter_{ITER}" / "temp"
    clip = "style=_style_exp_audio=speech"
    sr, wav = wavfile.read(temp / f"{clip}.wav")
    assert sr == 16000 and wav.shape == (24000,)
    assert (out / f"m_iter_{ITER}" / clip).is_dir()
    for seed in range(2):
        with open(temp / f"overall_exp_code_{clip}_seed_{seed}.pkl", "rb") as f:
            exp = pickle.load(f)
        with open(temp / f"overall_head_rot_{clip}_seed_{seed}.pkl", "rb") as f:
            rot = pickle.load(f)
        assert exp.shape == (37, 64) and rot.shape == (37, 3)
        assert np.isfinite(exp).all() and np.isfinite(rot).all()
