"""Rank functions for ``tests/test_torch_parallel.py`` and
``tests/test_torch_trainer.py``: ``msmd_tpu_torch.parallel.mesh.spawn``
runs them in child processes joined by gloo on the CPU. This module
imports no JAX (the children would pay for it), so the parity tests hand
every input over as NumPy: the model's Flax tree, the batch, the noise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
from msmd_tpu_torch.interop import load_flax_params
from msmd_tpu_torch.models.diffusion import get_diffusion_model, sample
from msmd_tpu_torch.models.layers import SampleRows
from msmd_tpu_torch.models.style_encoder import StyleEncoderVAE2
from msmd_tpu_torch.parallel import tp as tpar
from msmd_tpu_torch.parallel.mesh import make_layout, shard_batch
from msmd_tpu_torch.train import loop as tloop


# the truncated train-mode step: both clips cut at the ends drawn from a host generator of this seed, no swap
TRUNCATE = dict(trunc_prob1=1.0, trunc_prob2=1.0, prob_cross_style=0.0)
TRUNC_SEED = 3


class MeanStyle(nn.Module):
    """The style encoder with z = mu (no draw) and no dropout: the
    deterministic step."""

    def __init__(self, enc):
        super().__init__()
        self.enc = enc
        self.d_style = enc.d_style

    def forward(self, x, generator=None, train=False, eps=None):
        mu, logvar = self.enc.encode(x, None)
        return mu, mu, logvar


class NoDropout(nn.Module):
    """MSMD with dropout and SpecAugment off in train mode: the step's own
    draws (truncation, cross-style swap) stay, the modules' go."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.cfg = model.cfg

    def forward(self, *args, **kw):
        return self.model(*args, **dict(kw, train=False))

    def extract_audio_feature(self, audio, frame_num=None, rng=None):
        return self.model.extract_audio_feature(audio, frame_num)


def build(case: dict):
    """(cfg, model, style encoder) of ``case`` on the CPU, unsharded."""
    cfg = MSMDConfig(**case["cfg"])
    model = get_diffusion_model(cfg, audio_config=AudioEncoderConfig(**case["audio"]), device="cpu")
    load_flax_params(model, case["model"])
    enc = load_flax_params(StyleEncoderVAE2(d_style=cfg.d_style), case["style"])
    tloop.freeze(cfg, model)
    return cfg, model, enc


def full_named(module: nn.Module, grads: bool = False) -> dict:
    """{name: whole NumPy array} of the parameters (or gradients) of a
    possibly sharded module; every rank of its groups takes part."""
    shards = {id(p): (d, s) for p, d, s in tpar.param_shards(module)}
    out = {}
    for name, p in module.named_parameters():
        t = p.grad if grads else p.detach()
        if t is None:
            continue
        if id(p) in shards:
            t = tpar.whole(t, *shards[id(p)])
        out[name] = t.float().numpy().copy()
    return out


def deterministic_step(case: dict, tp: int, truncated: bool = False) -> dict:
    """The deterministic two-clip loss (eval mode, fixed timesteps and
    noise, z = mu) on this rank's rows (the plain step in one process),
    its gradients averaged over the data group, then one Adam update.
    With ``truncated`` the same in train mode with no dropout
    (``NoDropout``) and ``TRUNCATE``: both clips cut at the global batch's
    ends from a host generator seeded ``TRUNC_SEED``, so the ranks' frame
    counts differ. Returns the global loss, the whole gradients and the
    whole updated parameters."""
    layout = make_layout(tp)
    if truncated:
        case = dict(case, cfg=dict(case["cfg"], **TRUNCATE))
    cfg, model, enc = build(case)
    for m in (model, enc):
        tpar.shard_model(m, layout.tp_group, layout.tp_rank, layout.tp)
    style = MeanStyle(enc)
    B = case["batch"]["motion_0"].shape[0]
    rows = SampleRows(torch.Generator().manual_seed(0), layout.rows(B), B)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(case["batch"], layout).items()}
    pick = lambda arrs: [torch.from_numpy(a)[rows.index] for a in arrs]
    opt = tloop.TrainOptimizer(cfg, list(model.parameters()) + list(enc.parameters()))
    total, _ = tloop.two_clip_loss(cfg, NoDropout(model) if truncated else model, style, batch,
                                   torch.Generator().manual_seed(1),
                                   torch.Generator().manual_seed(TRUNC_SEED) if truncated else None, train=truncated,
                                   noise_pair=pick(case["noise"]), time_steps=pick(case["steps"]),
                                   rows=rows if layout.distributed else None)
    total.backward()
    layout.average_grads(opt.params)  # what the trainer's optimizer does before its update
    out = {"loss": float(layout.average(total.detach())), "n_sharded": tpar.count_tp_sharded(model),
           "grads": {"model": full_named(model, grads=True), "style": full_named(enc, grads=True)}}
    opt.step()
    out["params"] = {"model": full_named(model), "style": full_named(enc)}
    return out


def train_mode_step(case: dict, tp: int, exp_dir: str) -> dict:
    """One train-mode ``Trainer.fit`` iteration (dropout, truncation,
    cross-style, CFG drops) on a seeded loader batch, and its checkpoint.
    Returns the whole parameters after it."""
    from msmd_tpu_torch.train.trainer import Trainer

    layout = make_layout(tp)
    cfg = MSMDConfig(**dict(case["cfg"], tp_size=tp, max_iter=0, save_iter=1, val_iter=0, log_iter=1))
    trainer = Trainer(cfg, exp_dir, audio_config=AudioEncoderConfig(**case["audio"]), device="cpu", layout=layout)
    trainer.fit(iter([case["batch"]]))
    trainer.close()
    return {"model": full_named(trainer.model), "style": full_named(trainer.style_enc),
            "n_sharded": tpar.count_tp_sharded(trainer.model)}


def tp_sample(case: dict, tp: int) -> np.ndarray:
    """``sample`` of a tensor-parallel model (each tp group the same batch)."""
    layout = make_layout(tp)
    cfg, model, _ = build(case)
    tpar.shard_model(model, layout.tp_group, layout.tp_rank, layout.tp)
    s = case["sample"]
    out = sample(model, torch.from_numpy(s["audio"]), torch.from_numpy(s["shape"]), torch.from_numpy(s["style"]),
                 cfg_scale=1.15, generator=torch.Generator().manual_seed(7), device="cpu")[0]
    return out.numpy()


def sharded_generation(case: dict) -> dict:
    """``infer_coeffs`` and ``MotionGenerator.generate`` with their
    repetitions split over the ranks."""
    from msmd_tpu_torch.inference_lib import infer_coeffs
    from msmd_tpu_torch.serving import MotionGenerator

    layout = make_layout(1)
    cfg, model, enc = build(case)
    g = case["generate"]
    coeffs = infer_coeffs(model, g["audio"], np.zeros((1, 100), np.float32), style_feats=torch.from_numpy(g["style"]),
                          n_repetitions=g["R"], cfg_scale=1.15, generator=torch.Generator().manual_seed(3),
                          device="cpu", process_group=layout.dp_group)
    pinned = infer_coeffs(model, g["audio"], np.zeros((1, 100), np.float32), style_feats=torch.from_numpy(g["style"]),
                          n_repetitions=g["R"], cfg_scale=1.15, generator=torch.Generator().manual_seed(3),
                          device="cpu", process_group=layout.dp_group, motion_at_T=g["at_T"], noise_override=g["zs"])
    gen = MotionGenerator(model, enc, cfg, g["stats"], device="cpu")
    exp, rot = gen.generate(g["audio"], g["style_motion"], n_repetitions=g["R"], seed=5, process_group=layout.dp_group)
    return {"coeffs": coeffs.numpy(), "pinned": pinned.numpy(), "exp": exp, "rot": rot}


def nccl_world1(tmp: str, steps: int) -> dict:
    """On the card: ``steps`` train steps of a tiny trainer in one process
    and on the data-parallel layout of this NCCL rank (world size 1), from
    the same seeds, in PyTorch's deterministic mode (cuBLAS's workspace
    set before this process makes its handles)."""
    import os
    import warnings

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    from msmd_tpu_torch.parallel.mesh import Layout
    from msmd_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    audio = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, conv_dim=(16, 16, 16),
                 conv_kernel=(10, 3, 3), conv_stride=(5, 4, 4))
    cfg = MSMDConfig(feature_dim=128, n_heads=4, n_layers=2, mlp_ratio=4, d_style=16, num_of_basis=2, n_motions=8,
                     n_prev_motions=4, n_diff_steps=4, batch_size=4, fused_ffn_train=True, warm_iter=0)
    rs = np.random.RandomState(0)
    L = cfg.n_audio_samples
    batch = {"audio_0": rs.randn(4, L), "audio_1": rs.randn(4, L), "motion_0": rs.randn(4, 8, 67),
             "motion_1": rs.randn(4, 8, 67), "shape_0": np.zeros((4, 8, 100)), "shape_1": np.zeros((4, 8, 100))}
    losses, params = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for layout in (Layout(), make_layout(1)):
            t = Trainer(cfg, f"{tmp}/exp", audio_config=AudioEncoderConfig(**audio), device=dev, layout=layout)
            losses.append([float(t.train_one(batch)["loss"]) for _ in range(steps)])
            params.append([p.detach().clone() for p in list(t.model.parameters()) + list(t.style_enc.parameters())])
            t.close()
    return {"losses": losses, "distributed": layout.distributed,
            "params_bit_equal": all(torch.equal(a, b) for a, b in zip(*params))}


def fail_on_rank(rank: int) -> int:
    """Raises on ``rank`` (the launcher's failure path)."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError("this rank fails on purpose")
    return dist.get_rank()


def cli(argv) -> None:
    """The training CLI twin on this rank."""
    from msmd_tpu_torch.training_script import main

    main(list(argv))


def run_all(case: dict, tp: int, exp_dir: str, cli_argv=None) -> dict:
    """Everything one spawn of ranks checks, in one process each (a child
    costs seconds to start)."""
    out = {"deterministic": deterministic_step(case, tp), "truncated": deterministic_step(case, tp, truncated=True),
           "train": train_mode_step(case, tp, exp_dir)}
    if tp > 1:
        out["sample"] = tp_sample(case, tp)
    else:
        out["generation"] = sharded_generation(case)
    if cli_argv is not None:
        cli(cli_argv)
    return out
