"""The training loop around the two-clip step on one device: experiment
directory, logging, periodic evaluation, checkpoints and resume (the port
of ``msmd_tpu/train/trainer.py``; reference: training_script.py:49-241
train(), :244-403 test()). Data and tensor parallelism are not ported
(``tp_size > 1`` raises).
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.interop import load_flax_params, load_reference_pt, reference_msmd_to_flax, \
    reference_style_enc_to_flax
from msmd_tpu_torch.models.diffusion import get_diffusion_model
from msmd_tpu_torch.models.layers import init_params
from msmd_tpu_torch.models.style_encoder import get_style_encoder
from msmd_tpu_torch.train import checkpoint as ckpt
from msmd_tpu_torch.train.loop import TrainOptimizer, batch_to, eval_step, freeze, train_step
from msmd_tpu_torch.utils.logging import MetricWriter


class Trainer:
    """MSMD and the VAE2 style encoder with seeded random weights on
    ``device`` (default ``"cuda"``; it raises without a card unless the
    caller asks for the CPU), the optimizer, and the two generators of the
    step: one on the device, one on the host. ``flame`` (a ``FusedFlame``
    or a ``FlameModel`` on the device) and ``coef_stats`` (the
    denormalisation of the FLAME coefficients) feed the vertex-space loss
    (``msmd_tpu/train/trainer.py``:33-86)."""

    def __init__(self, cfg: MSMDConfig, exp_dir, audio_config: Optional[AudioEncoderConfig] = None,
                 device="cuda", flame=None, coef_stats: Optional[Dict] = None):
        if cfg.tp_size > 1:
            raise NotImplementedError("tensor parallelism (tp_size > 1) is not ported")
        if audio_config is not None and cfg.audio_encoder_config is None:
            cfg = cfg.replace(audio_encoder_config=dataclasses.asdict(audio_config))
        elif audio_config is None and cfg.audio_encoder_config is not None:
            audio_config = AudioEncoderConfig(
                **{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.audio_encoder_config.items()})
        self.cfg = cfg
        self.exp_dir = Path(exp_dir)
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.model = get_diffusion_model(cfg, audio_config=audio_config, dtype=dtype, device=self.device,
                                         seed=cfg.seed)
        # the encoder reads the motion of the batch, 67 wide on every layout (as JAX's init infers it)
        self.style_enc = init_params(get_style_encoder(cfg, dtype, input_dim=cfg.motion_feat_dim),
                                     cfg.seed + 1).to(self.device)
        self.flame = flame
        self.coef_stats = None if coef_stats is None else {
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device) for k, v in coef_stats.items()}
        freeze(cfg, self.model)
        self.opt = TrainOptimizer(cfg, list(self.model.parameters()) + list(self.style_enc.parameters()))
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.host_generator = torch.Generator().manual_seed(cfg.seed + 2)
        self.step = 0
        self.start_iter = 0
        self.writer = MetricWriter(self.exp_dir / "logs")

    # ------------------------------------------------------------------
    def maybe_resume(self, continue_from: Optional[str]) -> int:
        """Resume from an experiment directory: the native checkpoint if
        there is one (model, optimizer, step, generators), else the latest
        reference ``.pt`` (parameters only)."""
        if not continue_from:
            return 0
        exp = Path(continue_from)
        native = ckpt.latest_native(exp)
        if native is not None:
            state = ckpt.load_native(native, self.device)
            self.model.load_state_dict(state["model"])
            self.style_enc.load_state_dict(state["style_enc"])
            self.opt.load_state_dict(state["optimizer"])
            self.generator.set_state(state["generator"].cpu())
            self.host_generator.set_state(state["host_generator"].cpu())
            self.step, self.start_iter = int(state["step"]), int(state["iteration"])
            return self.start_iter
        pt = ckpt.find_latest_pt(exp / "checkpoints")
        if pt is None:
            raise ValueError(f"No checkpoints found under {exp}")
        _, model_sd, style_sd, it = load_reference_pt(pt)
        load_flax_params(self.model, reference_msmd_to_flax(model_sd, self.cfg))
        load_flax_params(self.style_enc, reference_style_enc_to_flax(style_sd))
        self.step = self.start_iter = it
        return it

    def save_checkpoint(self, iteration: int) -> None:
        ckpt.save_native(self.exp_dir, {
            "model": self.model.state_dict(), "style_enc": self.style_enc.state_dict(),
            "optimizer": self.opt.state_dict(), "step": self.step, "iteration": iteration,
            "generator": self.generator.get_state(), "host_generator": self.host_generator.get_state(),
        }, iteration)
        ckpt.save_reference_pt(self.exp_dir, self.cfg, self.model, self.style_enc, iteration)

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader=None, max_iter: Optional[int] = None, log_every: Optional[int] = None):
        """Iterations ``start_iter .. max_iter`` (both ends included, as the
        JAX trainer runs them): a step each, metrics logged every
        ``log_every``, checkpoints every ``save_iter`` and at ``max_iter``,
        validation every ``val_iter`` (0 turns it off)."""
        cfg = self.cfg
        max_iter = cfg.max_iter if max_iter is None else max_iter
        log_every = log_every or cfg.log_iter
        smooth = defaultdict(lambda: deque(maxlen=cfg.log_smooth_win))
        t0 = time.time()
        for it in range(self.start_iter, max_iter + 1):
            batch = batch_to(next(train_loader), self.device)
            metrics = train_step(cfg, self.model, self.style_enc, self.opt, batch, self.generator,
                                 self.host_generator, self.flame, self.coef_stats)
            self.step += 1
            for k, v in metrics.items():  # kept on the device until a log point
                smooth[k].append(v)
            if it % log_every == 0:
                means = {k: float(torch.stack(list(v)).float().mean()) for k, v in smooth.items()}
                rate = (it - self.start_iter + 1) / max(time.time() - t0, 1e-9)
                self.writer.scalars("train", means, it)
                self.writer.scalar("opt/steps_per_sec", rate, it)
                print(f"iter {it}: loss={means.get('loss', float('nan')):.4e} "
                      + " ".join(f"{k}={v:.3e}" for k, v in means.items() if k != "loss") + f" [{rate:.2f} it/s]",
                      flush=True)
            if (it % cfg.save_iter == 0 and it not in (0, self.start_iter)) or it == max_iter:
                self.save_checkpoint(it)
            if val_loader is not None and cfg.val_iter > 0 and (
                    (it % cfg.val_iter == 0 and it not in (0, self.start_iter)) or it == max_iter):
                cap = cfg.val_batches_cap if cfg.val_batches_cap > 0 else None
                self.evaluate(val_loader, it, n_rounds=1, mode="val", n_batches_per_round=cap)
        return self

    # ------------------------------------------------------------------
    def evaluate(self, val_loader, iteration: int, n_rounds: int = 10, mode: str = "val",
                 n_batches_per_round: Optional[int] = None, do_save: bool = False, save_path=None) -> Dict[str, float]:
        """Validation over the loader (reference: training_script.py:244-403),
        one full epoch per round unless ``n_batches_per_round`` caps it;
        writes mean/std/n JSON when ``do_save``."""
        if n_batches_per_round is None:
            try:
                n_batches_per_round = max(len(val_loader), 1)
            except TypeError:
                n_batches_per_round = 8
        gen = torch.Generator(device=self.device).manual_seed(1234 + iteration)
        log = defaultdict(list)
        for _ in range(n_rounds):
            for _ in range(n_batches_per_round):
                metrics = eval_step(self.cfg, self.model, self.style_enc, batch_to(next(val_loader), self.device), gen,
                                    flame=self.flame, coef_stats=self.coef_stats)
                for k, v in metrics.items():
                    log[k].append(float(v))
        means = {k: float(np.mean(v)) for k, v in log.items()}
        self.writer.scalars(mode, means, iteration)
        print(f"[{mode} @ {iteration}] " + " ".join(f"{k}={v:.4e}" for k, v in means.items()), flush=True)
        if do_save:
            stats = {k: {"mean": float(np.mean(v)), "std": float(np.std(v)), "n": len(v)} for k, v in log.items()}
            path = Path(save_path or (self.exp_dir / f"eval_{mode}_{iteration}.json"))
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(stats, indent=2))
        return means
