"""DDPM noise schedule tables (the port of ``msmd_tpu/ops/schedule.py``;
reference: model.py:20-71). All four beta modes, with the reference's
beta_0 = 0 padding and the alpha-bar taken as a cumulative log-sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def make_betas(num_steps: int, mode: str = "linear", beta_1: float = 1e-4, beta_T: float = 0.02, s: float = 0.008) -> np.ndarray:
    if mode == "linear":
        betas = np.linspace(beta_1, beta_T, num_steps, dtype=np.float64)
    elif mode == "quadratic":
        betas = np.linspace(beta_1 ** 0.5, beta_T ** 0.5, num_steps, dtype=np.float64) ** 2
    elif mode == "sigmoid":
        x = np.linspace(-5.0, 5.0, num_steps, dtype=np.float64)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_T - beta_1) + beta_1
    elif mode == "cosine":
        steps = num_steps + 1
        x = np.linspace(0, num_steps, steps, dtype=np.float64)
        alpha_bars = np.cos(((x / num_steps) + s) / (1 + s) * np.pi * 0.5) ** 2
        alpha_bars = alpha_bars / alpha_bars[0]
        betas = 1 - (alpha_bars[1:] / alpha_bars[:-1])
        betas = np.clip(betas, 0.0001, 0.999)
    else:
        raise ValueError(f"Unknown diffusion schedule {mode}!")
    return betas.astype(np.float32)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Tables indexed by t in [0, num_steps]; index 0 is the padded
    no-noise step. Held as float32 NumPy arrays: the sampler reads
    scalars from them on the host, one step at a time."""

    num_steps: int
    betas: np.ndarray  # (T+1,)
    alphas: np.ndarray
    alpha_bars: np.ndarray
    sigmas_flex: np.ndarray
    sigmas_inflex: np.ndarray

    @classmethod
    def create(cls, num_steps: int, mode: str = "linear", beta_1: float = 1e-4, beta_T: float = 0.02, s: float = 0.008) -> "DiffusionSchedule":
        betas = np.concatenate([np.zeros(1, np.float32), make_betas(num_steps, mode, beta_1, beta_T, s)])
        alphas = 1.0 - betas
        log_alphas = np.cumsum(np.log(alphas))  # the in-place loop at model.py:44-46
        alpha_bars = np.exp(log_alphas).astype(np.float32)
        sigmas_flex = np.sqrt(betas).astype(np.float32)
        sigmas_inflex = np.zeros_like(sigmas_flex)
        sigmas_inflex[1:] = ((1 - alpha_bars[:-1]) / (1 - alpha_bars[1:])) * betas[1:]
        sigmas_inflex = np.sqrt(sigmas_inflex).astype(np.float32)
        return cls(
            num_steps=num_steps,
            betas=betas,
            alphas=alphas.astype(np.float32),
            alpha_bars=alpha_bars,
            sigmas_flex=sigmas_flex,
            sigmas_inflex=sigmas_inflex,
        )

    def get_sigmas(self, t, flexibility: float = 0.0):
        """sigma(t) between the flexible (sqrt beta) and inflexible
        (posterior) variants (reference: model.py:68-71). ``t`` is an
        int or an integer array; returns float32 NumPy."""
        return (self.sigmas_flex[t] * np.float32(flexibility)
                + self.sigmas_inflex[t] * np.float32(1.0 - flexibility))
