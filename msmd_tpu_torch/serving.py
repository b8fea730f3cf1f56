"""Single-stream serving: a loaded speech-to-motion generator (the port of
``msmd_tpu/serving.py::MotionGenerator``), the programmatic twin of the
``python -m msmd_tpu_torch.inference`` CLI.

``MotionGenerator`` wraps model loading, style encoding, windowed
sampling and denormalisation in one object for a serving process. The
style draw and the sampler take ``torch.Generator``s seeded from
``seed``, so a seed gives the same motion on every call. The model of
an experiment is f32, as in the JAX package, so ``generate`` runs the
plain modules; the batch-1 sampler kernels serve a bf16 model
(``sample``/``infer_coeffs``). Multi-device serving and the continuous
multi-stream batcher are not ported yet.

Example:
    gen = MotionGenerator.from_experiment(root, name, "0470000", coef_stats)
    gen.warmup(max_seconds=20)
    exp_code, head_rot = gen.generate(audio_16k, style_motion, seed=0)
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.inference_lib import infer_coeffs, load_model


class MotionGenerator:
    def __init__(self, model, style_enc, cfg, coef_stats: Dict[str, np.ndarray], device="cuda"):
        self.model, self.style_enc, self.cfg = model, style_enc, cfg
        self.device = resolve_device(device)
        to_np = lambda v: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        self.coef_stats = {k: to_np(v) for k, v in coef_stats.items()}

    @classmethod
    def from_experiment(cls, model_root, model_name: str, iter_num: str, coef_stats, audio_config=None,
                        device="cuda") -> "MotionGenerator":
        model, style_enc, cfg = load_model(model_root, model_name, iter_num, audio_config=audio_config,
                                           device=device)
        return cls(model, style_enc, cfg, coef_stats, device=device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def encode_style(self, style_motion: np.ndarray, seed: int = 0, normalized: bool = False) -> torch.Tensor:
        """Style embedding (1, d_style) from a motion clip (T, 67): one
        draw from the style encoder on the first 100 frames, like the
        reference (inference.py:239)."""
        m = np.asarray(style_motion, np.float32)
        if not normalized:
            s = self.coef_stats
            exp = (m[:, :-3] - s["exp_mean"]) / (s["exp_std"] + 1e-9)
            rot = (m[:, -3:] - s["pose_mean"]) / (s["pose_std"] + 1e-9)
            m = np.concatenate([exp, rot], axis=-1)
        clip = torch.as_tensor(m[None, :100].astype(np.float32), device=self.device)
        return self.style_enc.sample(clip, generator=self._generator(seed))

    def generate(self, audio_16k: np.ndarray, style_motion: Optional[np.ndarray] = None, n_repetitions: int = 1,
                 cfg_scale: float = 1.4, seed: int = 0,
                 style_normalized: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """16 kHz audio (L,) -> (denormalised expression codes (R, T, 64),
        head rotations (R, T, 3))."""
        audio = np.asarray(audio_16k, np.float32)
        audio = (audio - audio.mean()) / (audio.std() + 1e-5)
        style = self.encode_style(style_motion, seed, style_normalized) if style_motion is not None else None
        coefs = infer_coeffs(
            self.model, audio, torch.zeros(1, 100), audio_unit=self.cfg.audio_unit, style_feats=style,
            n_repetitions=n_repetitions, cfg_scale=cfg_scale, dynamic_threshold=None,
            generator=self._generator(seed), device=self.device,
        ).float().cpu().numpy()
        s = self.coef_stats
        exp_code = coefs[..., :-3] * s["exp_std"] + s["exp_mean"]
        head_rot = coefs[..., -3:] * s["pose_std"] + s["pose_mean"]
        return exp_code, head_rot

    def warmup(self, max_seconds: float = 12.0, n_repetitions: int = 1) -> None:
        """Run the first-window and continuation paths once (a one- or
        two-window clip of silence), so that kernel builds and one-time
        allocations stay out of the first request."""
        cfg = self.cfg
        max_sub = max(1, math.ceil(int(max_seconds * cfg.fps) / cfg.n_motions))
        samples = int(cfg.n_audio_samples * min(2, max_sub))
        self.generate(np.zeros(samples, np.float32), None, n_repetitions=n_repetitions, seed=0)
