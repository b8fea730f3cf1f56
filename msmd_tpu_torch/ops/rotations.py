"""Rotation helpers the FLAME decode needs (the port of part of
``msmd_tpu/ops/rotations.py``)."""

from __future__ import annotations

import torch


def batch_rodrigues(rot_vecs: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3) by the Rodrigues
    formula with the reference's regularisation, angle = ||r + 1e-8||
    (reference: utils/lbs.py:270-301)."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=-1, keepdim=True)  # (N, 1)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1)
    K = K.reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1 - cos) * (K @ K)
