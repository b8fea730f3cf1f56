"""Learning-rate schedules (the port of ``msmd_tpu/train/scheduler.py``).

The reference's GradualWarmupScheduler with multiplier 1 (reference:
utils/scheduler.py:8-67, wired at training_script.py:572-581): the rate
ramps linearly from 0 to ``lr`` over ``warm_iter`` steps; 'WarmupThenDecay'
then cosine-anneals to ``lr * min_lr_ratio`` at ``cos_max_iter`` and holds.
Computed in float32 as the JAX package computes it, so both give the same
rate at every step.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


def warmup_schedule(lr: float, warm_iter: int):
    if warm_iter <= 0:  # no warmup: constant rate
        return lambda step: f32(lr)
    return lambda step: f32(lr) * np.minimum(f32(step) / f32(warm_iter), f32(1.0))


def warmup_then_cosine_schedule(lr: float, warm_iter: int, cos_max_iter: int, min_lr_ratio: float):
    min_lr = lr * min_lr_ratio

    def schedule(step):
        if step <= warm_iter:
            return f32(lr) * np.minimum(f32(step) / f32(max(warm_iter, 1)), f32(1.0))
        progress = np.clip(f32(step - warm_iter) / f32(max(cos_max_iter - warm_iter, 1)), f32(0.0), f32(1.0))
        return f32(min_lr) + f32(0.5 * (lr - min_lr)) * (f32(1.0) + np.cos(f32(np.pi) * progress))

    return schedule


def make_schedule(cfg):
    """step -> learning rate (float32)."""
    if cfg.scheduler == "Warmup":
        return warmup_schedule(cfg.lr, cfg.warm_iter)
    if cfg.scheduler == "WarmupThenDecay":
        return warmup_then_cosine_schedule(cfg.lr, cfg.warm_iter, cfg.cos_max_iter, cfg.min_lr_ratio)
    return lambda step: f32(cfg.lr)
