"""The port's training options against the JAX package on the CPU, at
the tiny geometry (``tiny_cfg``: 6 motions after 3 previous ones,
``synthetic_flame(n_verts=128)`` for the vertex-space loss):

- the vertex-space two-clip loss (HDTF layout, axis-angle pose, the
  decode through a ``FusedFlame``, FLAME-layout denormalisation
  statistics) in eval mode with fixed noise and timesteps, against
  ``jax.value_and_grad`` of the JAX ``two_clip_loss`` with its
  ``FusedFlame`` in interpret mode: the loss and each term to rtol 1e-5,
  every trainable parameter's gradient to 1e-4 x max |g| + 1e-6;
- ``two_clip_batch`` (one 2B-row forward): in eval with fixed noise and
  timesteps the port's batched loss and gradients equal its sequential
  ones (rtol 1e-5; gradients 2e-4 x max |g| + 1e-6, the JAX test's
  tolerance), and equal JAX's ``_two_clip_loss_batched`` (as above), in
  parameter space and in vertex space;
- ``remat_denoiser`` with dropout on (train mode, the same generators),
  with and without ``fused_ffn_train`` (its plain twin on the CPU): the
  loss and every gradient bit-equal to the run without remat, each
  decoder layer run twice (the forward and the recompute); the layer's
  masks come from a copy of the generator's state, and the generator
  ends where it would without remat;
- the style encoder at the HDTF layout's 54-wide first layer loads a JAX
  tree of that width and computes the same (mu, logvar), rtol 1e-5;
- one step of the training CLI twin on the CPU with ``--use_vertex_space``
  on an HDTF dataset, the fabricated ``generic_model.pkl``,
  ``--use_fused_lbs``, ``--two_clip_batch``, ``--remat_denoiser`` and
  FLAME-layout statistics.
"""

import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

from msmd_tpu_torch.config import MSMDConfig
from msmd_tpu_torch.interop import flax_tree
from msmd_tpu_torch.train import loop as tloop

from test_flame_loading import fake_assets  # noqa: F401  (the fabricated FLAME assets)
from test_torch_common import REPO, build_msmd_pair, counting_spy, np_params
from test_torch_train_step import _JaxMeanStyle, _MeanStyle, _batch, _style_pair

VERTEX = dict(dataset_type="HDTF_TFHP", use_vertex_space=True, rot_repr="aa")


def _stats():
    rs = np.random.RandomState(60)
    out = {}
    for k, n in (("shape", 100), ("exp", 50), ("pose", 6)):
        out[f"{k}_mean"] = (rs.randn(n) * 0.05).astype(np.float32)
        out[f"{k}_std"] = (0.2 + 0.3 * rs.rand(n)).astype(np.float32)
    return out


def _setting(vertex: bool, **kw):
    """The JAX and port models with the same weights, the style stubs, a
    batch, fixed noise and timesteps, and (vertex space) the FLAME decodes
    and statistics of both packages."""
    from msmd_tpu.models.flame import synthetic_flame as jsynth
    from msmd_tpu.ops.pallas.lbs_kernel import FusedFlame as JFused
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame

    kw = {**dict(n_motions=6, n_prev_motions=3, use_cross_style=True, do_ignore_cfg=True), **kw}
    if vertex:
        kw.update(VERTEX)
    jmodel, variables, tmodel, kw = build_msmd_pair(batch=2, **kw)
    jenc, sparams, tenc = _style_pair(kw["d_style"])
    cfg = MSMDConfig(**kw)
    batch = _batch(cfg, seed=3)
    rs = np.random.RandomState(5)
    noise = [rs.randn(2, cfg.n_motions, 67).astype(np.float32) for _ in range(2)]
    steps = [np.array([1, 3]), np.array([4, 2])]
    flames = (None, None)
    if vertex:
        flames = (JFused(jsynth(n_verts=128), interpret=True, batch_tile=8, vertex_tile=128),
                  FusedFlame(synthetic_flame(n_verts=128, device="cpu")))
    tloop.freeze(cfg, tmodel)
    return dict(jmodel=jmodel, params={"model": np_params(variables), "style_enc": sparams}, jenc=jenc,
                tmodel=tmodel, tenc=tenc, kw=kw, cfg=cfg, batch=batch, noise=noise, steps=steps, flames=flames,
                stats=_stats() if vertex else None)


def _jax_loss(s, monkeypatch, batched: bool):
    """(total, metrics, grads) of the JAX two-clip loss in eval mode with
    the setting's noise and timesteps."""
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.ops.schedule import DiffusionSchedule
    from msmd_tpu.train.loop import two_clip_loss as jloss

    jcfg = JCfg(**s["kw"], two_clip_batch=batched)
    drawn = [np.concatenate(s["steps"])] if batched else list(s["steps"])
    calls = iter(drawn * 4)
    monkeypatch.setattr(DiffusionSchedule, "uniform_sample_t", lambda self, key, n: jnp.asarray(next(calls)))
    stats = None if s["stats"] is None else {k: jnp.asarray(v) for k, v in s["stats"].items()}

    def loss_fn(p):
        return jloss(jcfg, s["jmodel"], _JaxMeanStyle(s["jenc"]), p, {k: jnp.asarray(v) for k, v in s["batch"].items()},
                     jax.random.PRNGKey(0), flame=s["flames"][0], train=False, eval_always_cross_style=True,
                     coef_stats=stats,
                     noise_pair=tuple(jnp.asarray(n) for n in s["noise"]))

    (total, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(s["params"])
    return float(total), {k: float(v) for k, v in metrics.items()}, grads


def _port_loss(s, batched: bool):
    """(total, metrics, grads by flax path) of the port's two-clip loss in
    eval mode with the setting's noise and timesteps."""
    cfg = MSMDConfig(**s["kw"], two_clip_batch=batched)
    for m in (s["tmodel"], s["tenc"]):
        m.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    total, metrics = tloop.two_clip_loss(cfg, s["tmodel"], _MeanStyle(s["tenc"]), tb, torch.Generator().manual_seed(0),
                                         train=False, eval_always_cross_style=True,
                                         noise_pair=[torch.from_numpy(n) for n in s["noise"]],
                                         time_steps=[torch.from_numpy(t) for t in s["steps"]],
                                         flame=s["flames"][1], coef_stats=s["stats"])
    total.backward()
    grads = {("model",) + k: v for k, v in traverse_util.flatten_dict(flax_tree(s["tmodel"], grads=True)).items()}
    grads.update({("style_enc",) + k: v
                  for k, v in traverse_util.flatten_dict(flax_tree(s["tenc"], grads=True)).items()})
    return float(total.detach()), {k: float(v) for k, v in metrics.items()}, grads


def _assert_grads_close(got: dict, want: dict, tol: float):
    assert len(got) > 10
    for k, g in got.items():
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= tol * np.abs(w).max() + 1e-6, k


def _jax_grads(jgrads, got):
    flat = traverse_util.flatten_dict(jgrads)
    return {k: flat[k] for k in got}


def test_vertex_space_two_clip_loss_matches_jax(monkeypatch):
    s = _setting(vertex=True)
    jtotal, jmetrics, jgrads = _jax_loss(s, monkeypatch, batched=False)
    total, metrics, grads = _port_loss(s, batched=False)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    assert set(metrics) == set(jmetrics) and metrics["vert"] > 0
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_grads_close(grads, _jax_grads(jgrads, grads), 1e-4)


@pytest.mark.parametrize("vertex", [False, True])
def test_two_clip_batch_equals_sequential_and_jax(monkeypatch, vertex):
    s = _setting(vertex=vertex)
    seq_total, seq_metrics, seq_grads = _port_loss(s, batched=False)
    total, metrics, grads = _port_loss(s, batched=True)
    np.testing.assert_allclose(total, seq_total, rtol=1e-5)
    for k, v in seq_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_grads_close(grads, seq_grads, 2e-4)
    assert np.abs(grads[("model", "start_motion_feat")]).max() > 0

    jtotal, jmetrics, jgrads = _jax_loss(s, monkeypatch, batched=True)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_grads_close(grads, _jax_grads(jgrads, grads), 1e-4)


@pytest.mark.parametrize("fused_ffn_train", [False, True])
def test_remat_denoiser_is_bit_equal_with_dropout(monkeypatch, fused_ffn_train):
    from msmd_tpu_torch.models import transformer

    s = _setting(vertex=False, fused_ffn_train=fused_ffn_train, do_ignore_cfg=False)
    cfg, model, enc = s["cfg"], s["tmodel"], s["tenc"]
    tb = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    counts = {}
    counting_spy(monkeypatch, transformer.TransformerDecoderLayer, "forward", counts, "layer")

    def run(remat: bool):
        model.cfg.remat_denoiser = remat
        for m in (model, enc):
            m.zero_grad(set_to_none=True)
        gen, host = torch.Generator().manual_seed(7), torch.Generator().manual_seed(8)
        counts["layer"] = 0
        total, _ = tloop.two_clip_loss(cfg, model, enc, tb, gen, host, train=True)
        forward_calls = counts["layer"]
        total.backward()
        grads = {n: p.grad.clone() for m in (model, enc) for n, p in m.named_parameters() if p.grad is not None}
        return total.detach(), grads, forward_calls, counts["layer"], gen.get_state()

    plain, remat = run(False), run(True)
    model.cfg.remat_denoiser = False
    layers = 2 * cfg.n_layers  # two clips
    assert plain[2] == plain[3] == layers  # no recompute without remat
    assert remat[2] == layers and remat[3] == 2 * layers  # each layer recomputed in the backward
    assert torch.equal(plain[0], remat[0])
    assert plain[1].keys() == remat[1].keys() and len(plain[1]) > 10
    for n, g in plain[1].items():
        assert torch.equal(g, remat[1][n]), n
    assert torch.equal(plain[4], remat[4])  # the generator ends where it would without remat


def test_hdtf_style_encoder_takes_a_54_wide_first_layer():
    from msmd_tpu.models.style_encoder import get_style_encoder as jget
    from msmd_tpu_torch.interop import load_flax_params
    from msmd_tpu_torch.models.style_encoder import get_style_encoder

    cfg = MSMDConfig(d_style=16, dataset_type="HDTF_TFHP")
    jenc = jget(cfg, "vae2")
    x = np.random.RandomState(90).randn(2, 12, 54).astype(np.float32)
    variables = jenc.init({"params": jax.random.PRNGKey(0), "style": jax.random.PRNGKey(1)}, jnp.asarray(x))
    assert variables["params"]["input_layers"]["conv_0"]["kernel"].shape == (3, 54, 512)
    enc = load_flax_params(get_style_encoder(cfg), np_params(variables))
    want = jenc.apply(variables, jnp.asarray(x), True, method=type(jenc)._encode)
    with torch.no_grad():
        got = enc.encode(torch.from_numpy(x))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_training_cli_twin_trains_in_vertex_space(fake_assets, tmp_path):  # noqa: F811
    from msmd_tpu_torch.data.synthetic import write_synthetic_dataset

    name = "HDTF_TFHP_tiny"
    write_synthetic_dataset(tmp_path / "data", name=name, n_videos=8, seed=0)
    np.savez(tmp_path / "stats.npz", **_stats())
    flags = ["--exp_name", "cli", "--data_root", str(tmp_path / "data"), "--dataset_type", name,
             "--batch_size", "2", "--max_iter", "1", "--save_iter", "1", "--val_iter", "0", "--log_iter", "1",
             "--feature_dim", "16", "--n_heads", "2", "--n_layers", "2", "--mlp_ratio", "2", "--d_style", "16",
             "--n_motions", "8", "--n_prev_motions", "4", "--n_diff_steps", "2", "--num_of_basis", "2",
             "--use_indicator", "--use_cross_style", "--tiny_audio_encoder", "--compute_dtype", "float32",
             "--exp_root", str(tmp_path / "exps"), "--fused_ffn_train", "--device", "cpu", "--rot_repr", "aa",
             "--use_vertex_space", "--flame_model_path", str(fake_assets / "generic_model.pkl"),
             "--use_fused_lbs", "--two_clip_batch", "--remat_denoiser",
             "--coef_stats_path", str(tmp_path / "stats.npz")]
    out = subprocess.run([sys.executable, "-m", "msmd_tpu_torch.training_script", *flags], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("iter 1: loss="))
    assert " vert=" in line and float(line.split(" vert=")[1].split()[0]) > 0
    (run,) = list((tmp_path / "exps").iterdir())
    cfg = MSMDConfig.load_args_json(run)
    assert cfg.two_clip_batch and cfg.remat_denoiser and cfg.use_vertex_space
    assert (run / "checkpoints" / "iter_0000001.pt").exists()
