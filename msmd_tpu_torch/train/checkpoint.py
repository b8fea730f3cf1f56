"""Checkpoints of the port's trainer (the port of ``msmd_tpu/train/checkpoint.py``).

Two formats:

1. Reference ``.pt``: ``<exp>/checkpoints/iter_%07d.pt`` holding {args,
   model, style_enc, iter} in the reference's names (reference:
   training_script.py:227-233; ``msmd_tpu/train/checkpoint.py``:64-80).
   Both packages' ``load_model`` and the JAX trainer's resume read it.
2. Native: ``<exp>/checkpoints/native/%07d.pt``, a ``torch.save`` of the
   model and style-encoder state dicts, the optimizer state, the step and
   the generators' states, for resuming this trainer where it stopped.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from msmd_tpu_torch.interop import flax_to_reference_msmd, flax_to_reference_style_enc, flax_tree


def save_reference_pt(exp_dir, cfg, model, style_enc, iteration: int) -> Path:
    """Write ``iter_%07d.pt`` from the port's modules."""
    path = Path(exp_dir) / "checkpoints"
    path.mkdir(parents=True, exist_ok=True)
    to_t = lambda sd: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    payload = {
        "args": cfg.to_dict(),
        "model": to_t(flax_to_reference_msmd(flax_tree(model), cfg)),
        "style_enc": to_t(flax_to_reference_style_enc(flax_tree(style_enc), style_enc.conv_feature_dim)),
        "iter": int(iteration),
    }
    file = path / f"iter_{iteration:07d}.pt"
    torch.save(payload, file)
    return file


def find_latest_pt(checkpoints_dir) -> Optional[Path]:
    """The latest ``iter_*.pt`` (the reference resume takes the
    lexicographically last: utils/model_common.py:72-77)."""
    files = sorted(Path(checkpoints_dir).glob("iter_*.pt"))
    return files[-1] if files else None


def save_native(exp_dir, state: dict, step: int) -> Path:
    path = Path(exp_dir) / "checkpoints" / "native"
    path.mkdir(parents=True, exist_ok=True)
    file = path / f"{step:07d}.pt"
    torch.save(state, file)
    return file


def latest_native(exp_dir) -> Optional[Path]:
    base = Path(exp_dir) / "checkpoints" / "native"
    files = sorted(p for p in base.glob("*.pt") if re.fullmatch(r"\d+", p.stem)) if base.exists() else []
    return files[-1] if files else None


def load_native(path, device) -> dict:
    return torch.load(Path(path), map_location=device, weights_only=False)
