"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. A caller
that wants the CPU (the tests do) passes ``device="cpu"``. Asking for
CUDA on a machine without it raises: the port never quietly carries on
on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
