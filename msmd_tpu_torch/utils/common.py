"""Small shared helpers (the port of ``msmd_tpu/utils/common.py``;
reference: utils/common.py:94-115 and utils/model_common.py:9-55)."""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
from torch import nn


def count_parameters(params) -> int:
    """The parameter count of an ``nn.Module`` (its parameters), or of a
    state dict or nested mapping of arrays (its leaves) (reference:
    utils/common.py:94-95)."""
    if isinstance(params, nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    if isinstance(params, Mapping):
        return int(sum(count_parameters(v) for v in params.values()))
    return int(np.prod(np.shape(params)))


def get_option_text(cfg, defaults=None) -> str:
    """A config as text, one option a line, marking each value that is not
    the default (reference: utils/common.py:98-106)."""
    from msmd_tpu_torch.config import MSMDConfig

    defaults = defaults or MSMDConfig()
    message = ""
    for k, v in sorted(cfg.to_dict().items()):
        comment = ""
        default = getattr(defaults, k, None)
        if v != default:
            comment = f"\t[default: {default}]"
        message += f"{str(k):>30}: {str(v):<30}{comment}\n"
    return message


def get_model_path(exp_name: str, iteration: int, model_type: str = "DPT", exp_root=None):
    """The checkpoint path of an experiment named by ``exp_name`` or a
    prefix of it (reference: utils/common.py:109-115). ``exp_root``
    defaults to ``experiments/<model_type>`` beside the package. Returns
    (model path, the experiment directory relative to the root)."""
    exp_root_dir = Path(exp_root) if exp_root else Path(__file__).parent.parent.parent / "experiments" / model_type
    exp_dir = exp_root_dir / exp_name
    if not exp_dir.exists():
        exp_dir = next(exp_root_dir.glob(f"{exp_name}*"))
    model_path = exp_dir / f"checkpoints/iter_{iteration:07}.pt"
    return model_path, exp_dir.relative_to(exp_root_dir)
