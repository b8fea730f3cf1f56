"""The port's data and tensor parallelism (``msmd_tpu_torch/parallel/``) on
the CPU, as gloo ranks spawned by ``parallel.mesh.spawn``, at the tiny
geometry, against the JAX package's ``("data", "model")`` mesh and the
port's one-process step:

- ``tp_spec`` decides as JAX's does for every leaf of the tiny model and
  style encoder, but where an attention's heads do not divide by tp (the
  port's head guard replicates what GSPMD would split);
- dp = 2 and dp = 2 x tp = 2: the deterministic two-clip loss (eval mode,
  fixed timesteps and noise, z = mu) and every gradient against
  ``jax.grad`` of JAX's step on ``make_dp_tp_mesh(2, 4)`` over the 8
  virtual devices: the loss to rtol 1e-5, each gradient to 1e-4 x max|g|
  + 1e-6 (``test_torch_train_step.py``'s bounds). One leaf is held
  against JAX's one-device step instead: on that mesh (jax 0.9.0, CPU)
  JAX's gradient of the grouped positional convolution's kernel is up to
  3x max |g| off its own one-device step, while the dp = 2, dp = 2 x
  tp = 2 and tp = 4 meshes agree with it (a fault of the reference's
  partitioned program, not of the port);
- the same in train mode with both clips truncated at ends drawn for the
  global batch (so the ranks hold different frame counts) and dropout
  off, against JAX's mesh step cut at the same ends and against the
  port's one-process step on the same host draws, at the same bounds:
  the masked means are the global batch's, whatever the rank count;
- one Adam update at dp x tp against the port's one-process update, at
  ``test_tensor_parallel.py``'s bounds (rtol 3e-3, atol 2e-5), on every
  element whose gradient is at least 1e-4 of the largest gradient, and at
  least half of them (Adam's first step moves each element by about
  lr x sign(g), which another summation order may flip where g is at
  rounding level: the attention key biases, whose exact gradient is 0,
  and the style encoder's logvar head, reached by the 1e-7 KL term);
- a train-mode ``Trainer.fit`` step leaves every rank's parameters equal,
  bit for bit, and tensor parallelism engaged;
- ``sample`` on a tp = 2 model against the unsharded model
  (``test_tp_sampler_matches_single_device``'s bounds, rtol 5e-4, atol
  5e-5); sharded ``infer_coeffs`` and ``MotionGenerator.generate`` at
  R = 4 over two ranks against the unsharded calls (atol 1e-4, as
  ``tests/test_serving.py::test_generator_multichip_mesh``), also with
  the initial noise and every step's z pinned to one global draw;
- the training CLI twin under two gloo ranks writes one experiment whose
  checkpoint both packages' ``load_model`` read.

Each spawn runs all of its checks in one child per rank; every child is
joined with a timeout (``spawn``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
from msmd_tpu_torch.interop import flax_path, flax_tree
from msmd_tpu_torch.parallel import tp as tpar
from msmd_tpu_torch.parallel.mesh import Layout, make_layout, shard_batch, spawn

import torch_parallel_workers as W
from test_torch_common import TINY_AUDIO, build_msmd_pair, np_params
from test_torch_train_step import _JaxMeanStyle, _batch, _style_pair

B = 4
SPAWN_TIMEOUT = 240
POS_CONV = ("model", "audio_encoder", "encoder", "pos_conv_embed", "conv", "kernel")


def _case_kw():
    return dict(batch=B, use_cross_style=True, do_ignore_cfg=True, lr=1e-3, warm_iter=0, batch_size=B,
                n_prev_motions=4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny model pair, the inputs, the JAX references and the
    spawned runs."""
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.ops.schedule import DiffusionSchedule
    from msmd_tpu.parallel.mesh import shard_batch as jshard
    from msmd_tpu.parallel.tp import make_dp_tp_mesh, tp_shardings
    from msmd_tpu.train.loop import two_clip_loss as jloss
    from msmd_tpu_torch.data.synthetic import write_synthetic_dataset

    jmodel, variables, tmodel, kw = build_msmd_pair(**_case_kw())
    jcfg, cfg = JCfg(**kw), MSMDConfig(**kw)
    jenc, sparams, tenc = _style_pair(kw["d_style"])
    batch = _batch(cfg, B=B)
    rs = np.random.RandomState(5)
    noise = [rs.randn(B, cfg.n_motions, 67).astype(np.float32) for _ in range(2)]
    steps = [np.array([1, 3, 4, 2]), np.array([4, 2, 1, 3])]
    L = cfg.n_audio_samples
    case = dict(
        cfg=kw, audio=TINY_AUDIO, model=np_params(variables), style=sparams, batch=batch, noise=noise, steps=steps,
        sample=dict(audio=(rs.randn(2, L) * 0.05).astype(np.float32), shape=np.zeros((2, 100), np.float32),
                    style=rs.randn(2, kw["d_style"]).astype(np.float32)),
        generate=dict(audio=(rs.randn(16000) * 0.1).astype(np.float32), style=rs.randn(1, kw["d_style"]).astype(
            np.float32), R=4, style_motion=rs.randn(120, 67).astype(np.float32),
            at_T=rs.randn(4, cfg.n_motions, 67).astype(np.float32),
            zs=rs.randn(cfg.n_diff_steps, 4, cfg.n_motions, 67).astype(np.float32),
            stats={"exp_mean": np.zeros(64, np.float32), "exp_std": np.ones(64, np.float32),
                   "pose_mean": np.zeros(3, np.float32), "pose_std": np.ones(3, np.float32) * 10}))

    params = {"model": np_params(variables), "style_enc": sparams}
    mesh = make_dp_tp_mesh(2, 4)

    def jax_reference(truncate):
        """JAX's deterministic loss and gradients, jitted on a dp = 2 x tp = 4
        mesh of the 8 virtual devices (the positional convolution's kernel
        from the one-device step, module docstring); with ``truncate`` (each
        clip's ends) in train mode with dropout off, cut at those ends."""
        import msmd_tpu.train.loop as jloop
        from msmd_tpu.losses import _truncate_seq

        c = JCfg(**dict(kw, **W.TRUNCATE)) if truncate else jcfg

        def cut(key, audio, motion, n_motions, audio_unit=640.0, pad_mode="zero", expression_code_size=50):
            end = jnp.asarray(next(ends))
            return (_truncate_seq(audio, (end * audio_unit).astype(jnp.int32), pad_mode),
                    _truncate_seq(motion, end, pad_mode), end)

        def loss_fn(p, b, n0, n1):
            return jloss(c, _JaxNoDropout(jmodel), _JaxNoDropout(_JaxMeanStyle(jenc)), p, b, jax.random.PRNGKey(0),
                         train=truncate is not None, noise_pair=(n0, n1))

        data = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
        runs = (lambda f: f(jax.device_put(params, tp_shardings(params, mesh)), jshard(batch, mesh),
                            *(jax.device_put(n, data) for n in noise)),
                lambda f: f(params, {k: jnp.asarray(v) for k, v in batch.items()}, *map(jnp.asarray, noise)))
        out = []
        for run in runs:
            drawn, ends = iter(steps), iter(truncate or ())
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(DiffusionSchedule, "uniform_sample_t", lambda self, key, n: jnp.asarray(next(drawn)))
                mp.setattr(jloop, "truncate_motion_coef_and_audio", cut)
                out.append(run(jax.jit(jax.value_and_grad(loss_fn, has_aux=True))))
        ((jtotal, _), jgrads), (_, one_device) = out
        ref = dict(loss=float(jtotal), grads=traverse_util.flatten_dict(jax.device_get(jgrads)))
        ref["grads"][POS_CONV] = np.asarray(traverse_util.flatten_dict(jax.device_get(one_device))[POS_CONV])
        return ref

    ends = _trunc_ends(B, cfg.n_motions)
    jref, jref_trunc = jax_reference(None), jax_reference(ends)

    # the port in one process: the same steps, the sampler, the generation
    one, one_trunc = W.deterministic_step(case, 1), W.deterministic_step(case, 1, truncated=True)
    root = tmp_path_factory.mktemp("torch_parallel")
    write_synthetic_dataset(root / "data", name="tinyset", n_videos=8, seed=0)
    cli = ["--exp_name", "dp", "--data_root", str(root / "data"), "--dataset_type", "tinyset",
           "--batch_size", "2", "--max_iter", "1", "--save_iter", "1", "--val_iter", "0", "--log_iter", "1",
           "--feature_dim", "16", "--n_heads", "2", "--n_layers", "1", "--mlp_ratio", "2", "--d_style", "16",
           "--n_motions", "8", "--n_prev_motions", "4", "--n_diff_steps", "2", "--num_of_basis", "2",
           "--use_indicator", "--use_cross_style", "--tiny_audio_encoder", "--compute_dtype", "float32",
           "--exp_root", str(root / "exps"), "--fused_ffn_train", "--device", "cpu"]
    runs = {
        "dp2": spawn(W.run_all, 2, "gloo", str(root / "store_dp"), (case, 1, str(root / "exp_dp"), cli),
                     timeout=SPAWN_TIMEOUT),
        "dp2xtp2": spawn(W.run_all, 4, "gloo", str(root / "store_tp"), (case, 2, str(root / "exp_tp")),
                         timeout=SPAWN_TIMEOUT),
    }
    return dict(case=case, cfg=cfg, jcfg=jcfg, params=params, tmodel=tmodel, tenc=tenc, jref=jref, one=one,
                jref_trunc=jref_trunc, one_trunc=one_trunc, ends=ends, runs=runs, root=root)


class _JaxNoDropout:
    """A JAX module applied with ``deterministic=True`` (no dropout, no
    SpecAugment) whatever the step asks for."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, *args, **kw):
        return self.module.apply(variables, *args, **dict(kw, deterministic=True))


def _trunc_ends(batch, n_motions):
    """Each clip's truncation ends as the port's step draws them from a host
    generator seeded ``TRUNC_SEED`` (per clip: the cross-style flag, the
    global batch's ends, the truncation flag)."""
    g = torch.Generator().manual_seed(W.TRUNC_SEED)
    ends = []
    for _ in range(2):
        torch.rand((), generator=g)
        ends.append(torch.randint(1, n_motions, (batch,), generator=g).numpy())
        torch.rand((), generator=g)
    return ends


def _grad_tree(setup, grads):
    """The port's whole gradients as the JAX package's flat tree."""
    out = {}
    for part, module, key in (("model", setup["tmodel"], "model"), ("style", setup["tenc"], "style_enc")):
        for name, g in grads[part].items():
            path = flax_path(module, name)
            out[(key,) + path] = g.T if path[-1] == "kernel" and g.ndim == 2 else \
                (g.transpose(2, 1, 0) if path[-1] == "kernel" else g)
    return out


@pytest.mark.parametrize("tp", [2, 3, 8])
def test_tp_spec_matches_jax(tp):
    from msmd_tpu.models.style_encoder import StyleEncoderVAE2 as JVAE2
    from msmd_tpu.parallel.tp import tp_spec as jspec
    from msmd_tpu_torch.models.style_encoder import StyleEncoderVAE2

    jmodel, variables, tmodel, kw = build_msmd_pair(batch=1)
    jenc = JVAE2(d_style=kw["d_style"])
    svars = jenc.init({"params": jax.random.PRNGKey(0), "style": jax.random.PRNGKey(1)}, np.zeros((1, 8, 67)))
    P = jax.sharding.PartitionSpec
    to_dim = {P(): None, P(None, "model"): 0, P("model", None): 1, P("model"): 0}
    guarded = 0
    for module, tree in ((tmodel, np_params(variables)), (StyleEncoderVAE2(d_style=kw["d_style"]), np_params(svars))):
        plan = tpar.shard_plan(module, tp)
        want = {path: to_dim[jspec(path, leaf, tp)] for path, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        want = {tuple(k.key for k in path): d for path, d in want.items()}
        assert len(want) == len(list(module.parameters()))
        for name, p in module.named_parameters():
            got, jdim = plan.get(name), want[flax_path(module, name)]
            attention = name.split(".")[-2] in tpar.ATTENTION if "." in name else False
            if got != jdim and got is None and attention and module.get_submodule(name.rsplit(".", 2)[0]).n_heads % tp:
                guarded += 1  # the head guard: JAX would split a head here
                continue
            assert got == jdim, (name, got, jdim)
    assert (guarded > 0) == (tp == 8)  # 4 heads at width 32: tp 8 splits heads, tp 3 divides nothing


def _check_against_jax(setup, got, jref):
    from msmd_tpu.train.loop import trainable_mask

    np.testing.assert_allclose(got["loss"], jref["loss"], rtol=1e-5)
    want = jref["grads"]
    mask = traverse_util.flatten_dict(trainable_mask(setup["jcfg"], setup["params"]))
    trainable = {k for k, v in mask.items() if v}
    grads = _grad_tree(setup, got["grads"])
    assert set(grads) <= trainable and len(grads) > 0.9 * len(trainable)
    for k in trainable - set(grads):  # off this loss's graph: JAX gives 0
        assert not np.asarray(want[k]).any(), k
    for k, g in grads.items():
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-6, k


@pytest.mark.parametrize("layout", ["dp2", "dp2xtp2"])
def test_loss_and_grads_match_jax_mesh(setup, layout):
    got = setup["runs"][layout][0]["deterministic"]
    _check_against_jax(setup, got, setup["jref"])
    if layout == "dp2xtp2":
        assert got["n_sharded"] > 20


@pytest.mark.parametrize("layout", ["dp2", "dp2xtp2"])
def test_truncated_train_loss_matches_jax_and_one_process(setup, layout):
    half = B // 2
    assert all(e[:half].sum() != e[half:].sum() for e in setup["ends"])  # the two data ranks' frame counts differ
    got, one = setup["runs"][layout][0]["truncated"], setup["one_trunc"]
    _check_against_jax(setup, got, setup["jref_trunc"])
    assert abs(got["loss"] - setup["one"]["loss"]) > 1e-3 * abs(setup["one"]["loss"])  # the cut changed the loss
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    for part in ("model", "style"):
        assert set(got["grads"][part]) == set(one["grads"][part])
        for name, g in one["grads"][part].items():
            assert np.abs(got["grads"][part][name] - g).max() <= 1e-4 * np.abs(g).max() + 1e-6, name


@pytest.mark.parametrize("layout", ["dp2", "dp2xtp2"])
def test_adam_step_matches_one_process(setup, layout):
    got, one = setup["runs"][layout][0]["deterministic"], setup["one"]
    top = max(np.abs(g).max() for part in ("model", "style") for g in one["grads"][part].values())
    checked = 0
    for part in ("model", "style"):
        for name, want in one["params"][part].items():
            g = one["grads"][part].get(name)
            if g is None:
                np.testing.assert_array_equal(got["params"][part][name], want, err_msg=name)
                continue
            sure = np.abs(g) >= 1e-4 * top
            np.testing.assert_allclose(got["params"][part][name][sure], want[sure], rtol=3e-3, atol=2e-5,
                                       err_msg=name)
            checked += int(sure.sum())
    assert checked > 0.5 * sum(g.size for part in ("model", "style") for g in one["grads"][part].values())


@pytest.mark.parametrize("layout", ["dp2", "dp2xtp2"])
def test_train_step_keeps_replicas_identical(setup, layout):
    runs = [r["train"] for r in setup["runs"][layout]]
    for r in runs[1:]:
        for part in ("model", "style"):
            assert set(r[part]) == set(runs[0][part])
            for name, v in runs[0][part].items():
                np.testing.assert_array_equal(r[part][name], v, err_msg=name)
    assert (runs[0]["n_sharded"] > 20) == (layout == "dp2xtp2")


def test_tp_sample_matches_one_process(setup):
    from msmd_tpu_torch.models.diffusion import sample

    s = setup["case"]["sample"]
    want = sample(setup["tmodel"], torch.from_numpy(s["audio"]), torch.from_numpy(s["shape"]),
                  torch.from_numpy(s["style"]), cfg_scale=1.15, generator=torch.Generator().manual_seed(7),
                  device="cpu")[0].numpy()
    for r in setup["runs"]["dp2xtp2"]:
        np.testing.assert_allclose(r["sample"], want, rtol=5e-4, atol=5e-5)


def test_sharded_generation_matches_unsharded(setup):
    from msmd_tpu_torch.inference_lib import infer_coeffs
    from msmd_tpu_torch.serving import MotionGenerator

    case = setup["case"]
    cfg, model, enc = W.build(case)
    g = case["generate"]
    coeffs = infer_coeffs(model, g["audio"], np.zeros((1, 100), np.float32), style_feats=torch.from_numpy(g["style"]),
                          n_repetitions=g["R"], cfg_scale=1.15, generator=torch.Generator().manual_seed(3),
                          device="cpu").numpy()
    exp, rot = MotionGenerator(model, enc, cfg, g["stats"], device="cpu").generate(
        g["audio"], g["style_motion"], n_repetitions=g["R"], seed=5)
    assert coeffs.shape == (4, 25, 67) and exp.shape == (4, 25, 64)
    for r in setup["runs"]["dp2"]:
        got = r["generation"]
        np.testing.assert_allclose(got["coeffs"], coeffs, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["exp"], exp, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["rot"], rot, atol=1e-4, rtol=1e-4)


def test_sharded_generation_with_pinned_noise_matches_unsharded(setup):
    from msmd_tpu_torch.inference_lib import infer_coeffs

    _, model, _ = W.build(setup["case"])
    g = setup["case"]["generate"]
    want = infer_coeffs(model, g["audio"], np.zeros((1, 100), np.float32), style_feats=torch.from_numpy(g["style"]),
                        n_repetitions=g["R"], cfg_scale=1.15, device="cpu", motion_at_T=g["at_T"],
                        noise_override=g["zs"]).numpy()
    free = setup["runs"]["dp2"][0]["generation"]["coeffs"]
    assert np.abs(want - free).max() > 1e-2  # the pinned noise is not the generator's
    for r in setup["runs"]["dp2"]:
        np.testing.assert_allclose(r["generation"]["pinned"], want, atol=1e-4, rtol=1e-4)


def test_cli_twin_under_two_ranks_writes_one_checkpoint(setup):
    from msmd_tpu.inference_lib import load_model as jload_model
    from msmd_tpu_torch.inference_lib import load_model

    exps = setup["root"] / "exps"
    (run,) = list(exps.iterdir())  # rank 0 named it, both ranks trained it
    assert sorted(p.name for p in (run / "checkpoints").glob("iter_*.pt")) == ["iter_0000001.pt"]
    assert len(list((run / "logs").glob("metrics.jsonl"))) == 1
    _, _, jmv, _, _ = jload_model(exps, run.name, "0000001")
    model, _, cfg = load_model(exps, run.name, "0000001", device="cpu")
    assert cfg.batch_size == 2 and cfg.tp_size == 1
    want = traverse_util.flatten_dict(np_params(jmv))
    got = traverse_util.flatten_dict(flax_tree(model))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=str(k))


def test_layout_rows_and_shards():
    lay = Layout(world=4, rank=3, tp=2)
    assert (lay.dp, lay.dp_rank, lay.tp_rank) == (2, 1, 1)
    assert lay.rows(6).tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="not divisible by the 2 data-parallel ranks"):
        lay.rows(5)
    batch = {"a": np.arange(12).reshape(6, 2), "s": np.float32(3.0)}
    got = shard_batch(batch, lay)
    assert got["a"].tolist() == [[6, 7], [8, 9], [10, 11]] and got["s"] == 3.0


def test_one_process_refuses_tensor_parallelism(tmp_path, monkeypatch):
    from msmd_tpu_torch.train.trainer import Trainer

    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_layout(2)
    cfg = MSMDConfig(feature_dim=16, n_heads=2, n_layers=1, mlp_ratio=2, d_style=16, n_motions=8, n_prev_motions=4,
                     n_diff_steps=2, num_of_basis=2, tp_size=2)
    with pytest.raises(ValueError, match="tp_size=2 but the layout has tp=1"):
        Trainer(cfg, tmp_path, audio_config=AudioEncoderConfig(**TINY_AUDIO), device="cpu")
    with pytest.raises(ValueError, match="batch_size=3 is not divisible"):
        Trainer(cfg.replace(tp_size=1, batch_size=3), tmp_path, device="cpu",
                layout=Layout(world=2, rank=0, tp=1))


def test_spawn_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(W.fail_on_rank, 2, "gloo", str(tmp_path / "store"), (1,), timeout=60)
