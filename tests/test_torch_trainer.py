"""The port's trainer, checkpoints and training CLI twin on the CPU, at a
tiny geometry, on the port's synthetic dataset:

- ``Trainer.fit`` takes 2 steps (iterations 0..1) and writes
  ``checkpoints/iter_0000001.pt``, a native checkpoint and logs;
- that ``.pt`` loads through the JAX package's ``load_reference_pt`` +
  ``reference_msmd_to_flax`` / ``reference_style_enc_to_flax`` and equals
  the trainer's parameters exactly (the positional convolution, stored as
  the reference's weight-norm pair (g, v) that the loader multiplies back,
  to 1 ulp); the port's ``load_model`` and the JAX ``load_model`` load
  identical parameters from it;
- ``python -m msmd_tpu_torch.inference --device cpu`` runs on it;
- a native resume continues the step and update counts where they were;
- the CLI twin trains with ``--device cpu``, and takes pretrained audio
  weights, a profiler trace and tensor parallelism over two gloo ranks.
"""

import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import traverse_util

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
from msmd_tpu_torch.interop import flax_tree

from test_torch_common import REPO, TINY_AUDIO, np_params

POS_CONV = ("audio_encoder", "encoder", "pos_conv_embed", "conv", "kernel")


def _cfg(data_root, **kw):
    base = dict(exp_name="t", data_root=str(data_root), dataset_type="tinyset", batch_size=2, max_iter=1,
                save_iter=1, val_iter=1, val_batches_cap=1, log_iter=1, feature_dim=16, n_heads=2, n_layers=1,
                mlp_ratio=2, d_style=16, n_motions=8, n_prev_motions=4, n_diff_steps=2, num_of_basis=2,
                use_indicator=True, use_cross_style=True, compute_dtype="float32", lr=1e-4, warm_iter=1,
                fused_ffn_train=True)
    base.update(kw)
    return MSMDConfig(**base)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from msmd_tpu_torch.data.pickle_dataset import get_dataset
    from msmd_tpu_torch.data.synthetic import write_synthetic_dataset
    from msmd_tpu_torch.train.trainer import Trainer

    root = tmp_path_factory.mktemp("torch_trainer")
    write_synthetic_dataset(root / "data", name="tinyset", n_videos=8, seed=0)
    cfg = _cfg(root / "data")
    exp = root / "DPT" / "run"
    exp.mkdir(parents=True)
    _, _, train_loader, val_loader = get_dataset(cfg, seed=cfg.seed)
    try:
        trainer = Trainer(cfg, exp, audio_config=AudioEncoderConfig(**TINY_AUDIO), device="cpu")
        trainer.cfg.save_args_json(exp)
        trainer.fit(train_loader, val_loader)
    finally:
        train_loader.close()
        val_loader.close()
    return root, exp, trainer


def test_fit_takes_two_steps_and_writes_checkpoints(trained):
    _, exp, trainer = trained
    assert trainer.step == 2 and trainer.opt.updates == 2
    assert (exp / "checkpoints" / "iter_0000001.pt").exists()
    assert (exp / "checkpoints" / "native" / "0000001.pt").exists()
    assert (exp / "args.json").exists() and (exp / "logs" / "metrics.jsonl").stat().st_size > 0


def test_reference_pt_loads_in_jax_and_equals_the_trainer(trained):
    from msmd_tpu.interop.msmd_checkpoint import reference_msmd_to_flax, reference_style_enc_to_flax
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.train.checkpoint import load_reference_pt

    _, exp, trainer = trained
    args, model_sd, style_sd, it = load_reference_pt(exp / "checkpoints" / "iter_0000001.pt")
    assert it == 1 and args["fused_ffn_train"] is True
    jcfg = JCfg.from_dict(args)
    for jtree, module in ((reference_msmd_to_flax(model_sd, jcfg), trainer.model),
                          (reference_style_enc_to_flax(style_sd), trainer.style_enc)):
        want = traverse_util.flatten_dict(jtree)
        got = traverse_util.flatten_dict(flax_tree(module))
        assert set(got) == set(want)
        for k, v in got.items():
            w = np.asarray(want[k])
            if k == POS_CONV:
                np.testing.assert_allclose(v, w, rtol=2.4e-7, atol=0, err_msg=str(k))
            else:
                np.testing.assert_array_equal(v, w, err_msg=str(k))


def test_port_and_jax_load_model_agree(trained):
    from msmd_tpu.inference_lib import load_model as jload_model
    from msmd_tpu_torch.inference_lib import load_model

    root, _, _ = trained
    _, _, jmv, jsv, _ = jload_model(root, "run", "0000001")
    model, style_enc, cfg = load_model(root, "run", "0000001", device="cpu")
    assert cfg.fused_ffn_train and cfg.audio_encoder_config is not None
    for mod, jvars in ((model, jmv), (style_enc, jsv)):
        want = traverse_util.flatten_dict(np_params(jvars))
        got = traverse_util.flatten_dict(flax_tree(mod))
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=str(k))


def test_inference_cli_twin_runs_on_the_checkpoint(trained, tmp_path):
    root, _, _ = trained
    rs = np.random.RandomState(1)
    pickle.dump(rs.randn(60, 64).astype(np.float32), open(tmp_path / "exp.pkl", "wb"))
    pickle.dump((rs.randn(60, 3) * 10).astype(np.float32), open(tmp_path / "head.pkl", "wb"))
    stats = {"exp_mean": np.zeros(64, np.float32), "exp_std": np.ones(64, np.float32),
             "pose_mean": np.zeros(3, np.float32), "pose_std": np.ones(3, np.float32)}
    pickle.dump(stats, open(tmp_path / "stats.pkl", "wb"))
    from scipy.io import wavfile

    wavfile.write(tmp_path / "a.wav", 16000, (rs.randn(8000) * 0.1).astype(np.float32))
    cmd = [sys.executable, "-m", "msmd_tpu_torch.inference", "--model_root", str(root), "--model_name", "run",
           "--model_iter", "0000001", "--style_clip_exp_code_path", str(tmp_path / "exp.pkl"),
           "--style_clip_head_rot_path", str(tmp_path / "head.pkl"), "--audio_clip", str(tmp_path / "a.wav"),
           "--coef_dict_path", str(tmp_path / "stats.pkl"), "--output_dir", str(tmp_path / "out"), "--device", "cpu"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert list((tmp_path / "out").rglob("*.pkl"))


def test_native_resume_continues_the_counts(trained):
    from msmd_tpu_torch.data.pickle_dataset import get_dataset
    from msmd_tpu_torch.train.trainer import Trainer

    _, exp, first = trained
    cfg = first.cfg.replace(max_iter=2, val_iter=0)
    trainer = Trainer(cfg, exp, device="cpu")
    assert trainer.maybe_resume(str(exp)) == 1
    assert (trainer.step, trainer.opt.updates) == (2, 2)
    for a, b in zip(trainer.model.parameters(), first.model.parameters()):
        assert torch.equal(a, b)
    _, _, loader, val = get_dataset(cfg, seed=cfg.seed)
    try:
        trainer.fit(loader)  # iterations 1..2, as the JAX trainer resumes
    finally:
        loader.close()
        val.close()
    assert (trainer.step, trainer.opt.updates) == (4, 4)
    assert (exp / "checkpoints" / "iter_0000002.pt").exists()


def test_training_cli_twin_runs_on_the_cpu(trained, tmp_path):
    root, _, _ = trained
    flags = ["--exp_name", "cli", "--data_root", str(root / "data"), "--dataset_type", "tinyset",
             "--batch_size", "2", "--max_iter", "1", "--save_iter", "1", "--val_iter", "0", "--log_iter", "1",
             "--feature_dim", "16", "--n_heads", "2", "--n_layers", "1", "--mlp_ratio", "2", "--d_style", "16",
             "--n_motions", "8", "--n_prev_motions", "4", "--n_diff_steps", "2", "--num_of_basis", "2",
             "--use_indicator", "--use_cross_style", "--tiny_audio_encoder", "--compute_dtype", "float32",
             "--exp_root", str(tmp_path / "exps"), "--fused_ffn_train", "--device", "cpu"]
    out = subprocess.run([sys.executable, "-m", "msmd_tpu_torch.training_script", *flags], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "iter 1: loss=" in out.stdout
    (run,) = list((tmp_path / "exps").iterdir())
    assert (run / "args.json").exists() and (run / "checkpoints" / "iter_0000001.pt").exists()
    cfg = MSMDConfig.load_args_json(run)
    assert cfg.fused_ffn_train and cfg.audio_encoder_config["hidden_size"] == 32


def test_training_cli_twin_refuses_unported_paths(trained, tmp_path):
    """The flags this test once saw refused now run (the name is kept):
    ``--audio_weights`` with ``--audio_weights_cache`` (an HF cache layout
    of a seeded encoder, written through the port's HF naming and its
    safetensors writer) and ``--profile_dir`` in one run, whose checkpoint
    holds the written encoder in its frozen parameters and whose trace
    file is on disk; and ``--tp_size 2`` under two gloo ranks, which writes
    one checkpoint that the port's ``load_model`` reads."""
    from msmd_tpu_torch.hf_loader import write_safetensors
    from msmd_tpu_torch.inference_lib import load_model
    from msmd_tpu_torch.interop import _hf_audio_out
    from msmd_tpu_torch.models.audio import AudioEncoder, audio_param_trainable
    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.parallel.mesh import spawn
    from msmd_tpu_torch.training_script import main

    import torch_parallel_workers as W

    root, _, _ = trained
    enc = init_params(AudioEncoder(AudioEncoderConfig(**TINY_AUDIO)), 7)
    sd = {}
    _hf_audio_out(sd, "hubert", flax_tree(enc))
    snap = tmp_path / "hf" / "models--org--tiny" / "snapshots" / "rev0"
    snap.mkdir(parents=True)
    write_safetensors(snap / "model.safetensors", {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    (snap / "config.json").write_text('{"model_type": "hubert"}')
    flags = ["--data_root", str(root / "data"), "--dataset_type", "tinyset", "--batch_size", "2", "--val_iter", "0",
             "--feature_dim", "16", "--n_heads", "2", "--n_layers", "1", "--mlp_ratio", "2", "--d_style", "16",
             "--n_motions", "8", "--n_prev_motions", "4", "--n_diff_steps", "2", "--num_of_basis", "2",
             "--use_indicator", "--use_cross_style", "--tiny_audio_encoder", "--compute_dtype", "float32",
             "--fused_ffn_train", "--device", "cpu"]
    main(flags + ["--exp_name", "hf", "--exp_root", str(tmp_path / "exps"), "--max_iter", "10", "--save_iter", "100",
                  "--log_iter", "5", "--audio_weights", "org/tiny", "--audio_weights_cache", str(tmp_path / "hf"),
                  "--profile_dir", str(tmp_path / "prof")])
    (run,) = list((tmp_path / "exps").iterdir())
    assert list((tmp_path / "prof").glob("*.pt.trace.json"))
    model, _, cfg = load_model(tmp_path / "exps", run.name, "0000010", device="cpu")
    frozen = [n for n, _ in enc.named_parameters() if not audio_param_trainable(cfg.audio_model, n)]
    assert frozen
    for name in frozen:
        assert torch.equal(model.audio_encoder.get_parameter(name), enc.get_parameter(name)), name

    spawn(W.cli, 2, "gloo", str(tmp_path / "store"),
          (flags + ["--exp_name", "tp", "--exp_root", str(tmp_path / "tp"), "--max_iter", "1", "--save_iter", "1",
                    "--log_iter", "1", "--tp_size", "2"],), timeout=240)
    (run,) = list((tmp_path / "tp").iterdir())
    assert sorted(p.name for p in (run / "checkpoints").glob("iter_*.pt")) == ["iter_0000001.pt"]
    model, _, cfg = load_model(tmp_path / "tp", run.name, "0000001", device="cpu")
    assert cfg.tp_size == 2 and model.denoising_net.transformer.layers[0].ffn.linear1.weight.shape == (32, 16)
