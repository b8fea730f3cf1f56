"""Training CLI of the port, the twin of the root ``training_script.py``
(reference: training_script.py:446-515):

    python -m msmd_tpu_torch.training_script --exp_name ... --data_root ... [--device cpu]
    python -m torch.distributed.run --nproc_per_node N -m msmd_tpu_torch.training_script ... [--tp_size T]

The same flags plus ``--device`` (default ``cuda``; it raises without a
card). Under ``torchrun`` every rank runs this script: data parallel over
N / T ranks (``--batch_size`` is the global batch) and, with ``--tp_size
T``, tensor parallel over groups of T ranks (``train/trainer.py``); NCCL
on the card, gloo on the CPU. It writes ``<exp_root>/<exp_name>-<stamp>/args.json``, the
reference checkpoints ``checkpoints/iter_%07d.pt`` (which
``python -m msmd_tpu_torch.inference`` and the root ``inference.py`` both
load) and the port's native checkpoints under ``checkpoints/native``.
With ``--use_vertex_space`` on an HDTF layout the loss decodes FLAME
vertices from ``--flame_model_path`` (through the fused decode, K5 and its
backward, with ``--use_fused_lbs``), as the root script wires it
(training_script.py:144-154). ``--coef_stats_path`` (an .npz or .pkl of
shape_/exp_/pose_ mean and std in the FLAME layout: 100, 50 and 6 wide)
denormalises the coefficients before the decode; the JAX script hands the
train set's normalisation statistics there instead (64 + 3 wide, no
shape), which its denormalisation cannot read, so the port does not, and
decodes the coefficients as they are when no file is given.
``--audio_weights`` (a local HF directory, or a model name under
``--audio_weights_cache``) loads a pretrained audio encoder
(``hf_loader.py``) before any resume; ``--profile_dir`` writes a profiler
trace of iterations 10-15 there (``utils/profiling.py``).
"""

from __future__ import annotations

import argparse
import pickle
from datetime import datetime
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MSMD training script (PyTorch port)")
    p.add_argument("--mode", type=str, default="train", choices=["train", "test"])
    p.add_argument("--exp_name", type=str, required=True, help="experiment name")
    p.add_argument("--data_root", type=str, required=True, help="path to dataset")
    p.add_argument("--max_iter", type=int, default=2000000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--generator_model_style", type=str, default="MSMD")
    p.add_argument("--style_enc_model_style", type=str, default="vae2")
    p.add_argument("--training_loss_style", type=str, default="MSMD")
    p.add_argument("--dataset_type", type=str, default="ravdess+celebv-text-medium")
    p.add_argument("--audio_model", type=str, default="hubert", choices=["hubert", "wav2vec2", "wavlm"])
    p.add_argument("--d_style", type=int, default=256)
    p.add_argument("--use_indicator", action="store_true")
    p.add_argument("--use_cross_style", action="store_true")
    p.add_argument("--use_vertex_space", action="store_true")
    p.add_argument("--num_of_basis", type=int, default=4)
    p.add_argument("--prob_cross_style", type=float, default=0.5)
    for name, default in (("l_vert", 1.0), ("l_vel", 0.5), ("l_smooth", 10.0), ("l_kl_div", 1e-7),
                          ("l_head_angle", 1.0), ("l_head_vel", 0.5), ("l_head_smooth", 0.5), ("l_head_trans", 0.5)):
        p.add_argument(f"--{name}", type=float, default=default)
    p.add_argument("--scheduler", type=str, default="Warmup", choices=["Warmup", "WarmupThenDecay"])
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--warm_iter", type=int, default=5000)
    p.add_argument("--cos_max_iter", type=int, default=1000000)
    p.add_argument("--min_lr_ratio", type=float, default=0.1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--n_motions", type=int, default=100)
    p.add_argument("--n_prev_motions", type=int, default=10)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--trunc_prob1", type=float, default=0.5)
    p.add_argument("--trunc_prob2", type=float, default=0.5)
    p.add_argument("--pad_mode", type=str, default="zero")
    p.add_argument("--rot_repr", type=str, default="euler")
    p.add_argument("--no_head_pose", action="store_true")
    p.add_argument("--do_ignore_shape", action="store_true")
    p.add_argument("--do_ignore_cfg", action="store_true")
    p.add_argument("--log_iter", type=int, default=100)
    p.add_argument("--save_iter", type=int, default=10000)
    p.add_argument("--val_iter", type=int, default=10000)
    p.add_argument("--log_smooth_win", type=int, default=50)
    p.add_argument("--continue_from", type=str, default=None)
    p.add_argument("--target", type=str, default="sample", choices=["noise", "sample"])
    p.add_argument("--criterion", type=str, default="l2", choices=["l1", "l2"])
    p.add_argument("--architecture", type=str, default="decoder")
    p.add_argument("--feature_dim", type=int, default=512)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--mlp_ratio", type=int, default=4)
    p.add_argument("--align_mask_width", type=int, default=1)
    p.add_argument("--no_use_learnable_pe", action="store_true")
    p.add_argument("--n_diff_steps", type=int, default=500)
    p.add_argument("--diff_schedule", type=str, default="cosine")
    p.add_argument("--cfg_mode", type=str, default="incremental", choices=["independent", "incremental"])
    p.add_argument("--guiding_conditions", type=str, default="style,audio")
    p.add_argument("--no_constrain_prev", action="store_true")
    p.add_argument("--regularize_alpha", type=str, default="None")
    # the JAX package's additions
    p.add_argument("--exp_root", type=str, default="experiments/DPT", help="experiment root dir")
    p.add_argument("--compute_dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--flame_model_path", type=str, default=None)
    p.add_argument("--tiny_audio_encoder", action="store_true", help="debug-size audio encoder (tests)")
    p.add_argument("--audio_weights", type=str, default=None,
                   help="local HF dir (or cache root) with pretrained wav2vec2/hubert weights")
    p.add_argument("--audio_weights_cache", type=str, default=None, help="HF cache root for --audio_weights")
    p.add_argument("--profile_dir", type=str, default=None, help="write a torch.profiler trace of steps 10-15 here")
    p.add_argument("--use_fused_lbs", action="store_true",
                   help="vertex-space loss: decode FLAME vertices through the fused kernel (K5, K5 bwd)")
    p.add_argument("--coef_stats_path", type=str, default=None,
                   help="vertex-space loss: FLAME-layout coefficient stats (.npz/.pkl) to denormalise with")
    p.add_argument("--val_batches_cap", type=int, default=0,
                   help="cap batches per periodic-validation round (<= 0: the reference's full epoch)")
    p.add_argument("--fused_ffn_train", action="store_true",
                   help="training FFN block (FFN, dropout, residual, LayerNorm) through the K7 kernel")
    p.add_argument("--identity_band_train", action=argparse.BooleanOptionalAction, default=True,
                   help="identity-band cross-attention in training too (width-1 band)")
    p.add_argument("--remat_denoiser", action="store_true",
                   help="checkpoint every decoder layer: recompute its activations in the backward")
    p.add_argument("--two_clip_batch", action="store_true", help="both clips as one 2B-row forward")
    p.add_argument("--tp_size", type=int, default=1,
                   help="tensor-parallel group size (ranks under torchrun; the rest is data parallel)")
    p.add_argument("--batch_overfit_size", type=int, default=-1, help="overfit smoke mode: dataset of k items")
    p.add_argument("--device", type=str, default="cuda", help="device to run on (cuda or cpu)")
    return p


TINY_AUDIO = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                  conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 4, 4))
# WavLM's layout at the tiny widths (--audio_model wavlm --tiny_audio_encoder)
TINY_WAVLM = dict(TINY_AUDIO, feat_extract_norm="layer", do_stable_layer_norm=True, num_buckets=32,
                  max_bucket_distance=64)


def audio_config_of(args):
    """The audio encoder the flags ask for: the tiny one, else WavLM-Large
    for wavlm, so that args.json records its widths (None: the model's
    default, HuBERT-base)."""
    from msmd_tpu_torch.config import AudioEncoderConfig, default_audio_config

    if args.tiny_audio_encoder:
        return AudioEncoderConfig(**(TINY_WAVLM if args.audio_model == "wavlm" else TINY_AUDIO))
    return default_audio_config(args.audio_model) if args.audio_model == "wavlm" else None


def _load_stats(path) -> dict:
    """Coefficient statistics from an .npz or a pickled dict."""
    if str(path).endswith(".npz"):
        return dict(np.load(path))
    with open(path, "rb") as f:
        return dict(pickle.load(f))


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    from msmd_tpu_torch.config import MSMDConfig, is_hdtf
    from msmd_tpu_torch.data.pickle_dataset import get_dataset
    from msmd_tpu_torch.device import resolve_device
    from msmd_tpu_torch.parallel.mesh import make_layout
    from msmd_tpu_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    layout = make_layout(args.tp_size, backend="nccl" if dev.type == "cuda" else "gloo")
    if layout.distributed and dev.type == "cuda":
        dev = torch.device("cuda", layout.local_rank)
    audio_config = audio_config_of(args)
    cfg = MSMDConfig.from_dict(vars(args))
    if args.continue_from:
        exp_dir = Path(args.continue_from)
    else:  # rank 0 names the experiment
        stamp = layout.broadcast_object(datetime.now().strftime('%y%m%d_%H%M%S'))
        exp_dir = Path(args.exp_root) / f"{args.exp_name}-{stamp}"
        if layout.is_main:
            exp_dir.mkdir(parents=True, exist_ok=True)

    flame = coef_stats = None
    if cfg.use_vertex_space and is_hdtf(cfg.dataset_type) and (cfg.l_vert > 0 or cfg.l_vel > 0):
        from msmd_tpu_torch.models.flame import FLAMEConfig, load_flame

        flame = load_flame(FLAMEConfig(flame_model_path=cfg.flame_model_path), device=dev)
        if args.use_fused_lbs:
            from msmd_tpu_torch.ops.kernels.lbs import FusedFlame

            flame = FusedFlame(flame)
        if cfg.coef_stats_path:
            coef_stats = _load_stats(cfg.coef_stats_path)

    say = print if layout.is_main else (lambda *a, **k: None)
    say(f"Loading dataset {cfg.dataset_type} from {cfg.data_root}", flush=True)
    _, _, train_loader, val_loader = get_dataset(cfg, batch_overfit_size=args.batch_overfit_size, seed=cfg.seed)
    trainer = Trainer(cfg, exp_dir, audio_config=audio_config, device=dev, flame=flame, coef_stats=coef_stats,
                      layout=layout)
    if args.audio_weights:
        trainer.load_pretrained_audio(args.audio_weights, args.audio_weights_cache)
        say(f"Loaded pretrained audio-encoder weights from {args.audio_weights}", flush=True)
    if args.continue_from:
        start = trainer.maybe_resume(args.continue_from)
        say(f"Resumed from {args.continue_from} at iteration {start}", flush=True)
    n_params = sum(p.numel() for m in (trainer.model, trainer.style_enc) for p in m.parameters())
    say(f"Experiment dir: {exp_dir} | params: {n_params:,} on this rank | device: {dev} | ranks: "
        f"{layout.world} (dp {layout.dp} x tp {layout.tp})", flush=True)
    try:
        if args.mode == "train":
            if layout.is_main:
                trainer.cfg.save_args_json(exp_dir)
            trainer.fit(train_loader, val_loader, profile_dir=args.profile_dir)
        else:
            metrics = trainer.evaluate(val_loader, trainer.start_iter, n_rounds=5, mode="test", do_save=True)
            say("Test results:")
            for k, v in metrics.items():
                say(f"{k}: {v:.4f}")
    finally:
        trainer.close()
        train_loader.close()
        val_loader.close()


if __name__ == "__main__":
    main()
