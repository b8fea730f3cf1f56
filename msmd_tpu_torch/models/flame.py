"""FLAME head model, vertices only (the port of part of
``msmd_tpu/models/flame.py``; reference: utils/flame.py:59-244).

The licensed ``generic_model.pkl`` is not shipped; ``synthetic_flame``
builds a random model with FLAME's joint tree and buffer shapes from
the same ``np.random.RandomState(seed)`` draws as the JAX package, so
both packages hold identical buffers for a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.ops.lbs import lbs

FLAME_N_VERTS = 5023
FLAME_N_JOINTS = 5  # global, neck, jaw, left eye, right eye


@dataclass(frozen=True)
class FlameModel:
    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, n_shape + n_exp)
    posedirs: torch.Tensor  # ((J-1)*9, V*3)
    J_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: np.ndarray  # (J,) static
    faces: np.ndarray  # (F, 3) static

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device


def synthetic_flame(n_verts: int = FLAME_N_VERTS, n_shape: int = 100, n_exp: int = 50, seed: int = 0,
                    device="cuda") -> FlameModel:
    """A random FLAME-shaped model (``flame.py::synthetic_flame``'s draws,
    in its order) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    n_joints = FLAME_N_JOINTS
    parents = np.array([-1, 0, 1, 1, 1], np.int64)
    v_template = rng.randn(n_verts, 3).astype(np.float32) * 0.1
    shapedirs = rng.randn(n_verts, 3, n_shape + n_exp).astype(np.float32) * 0.01
    posedirs = rng.randn((n_joints - 1) * 9, n_verts * 3).astype(np.float32) * 0.001
    J_regressor = rng.rand(n_joints, n_verts).astype(np.float32)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    lbs_weights = rng.rand(n_verts, n_joints).astype(np.float32)
    lbs_weights /= lbs_weights.sum(axis=1, keepdims=True)
    n_faces = max(n_verts - 2, 1)
    faces = np.stack(
        [np.arange(n_faces), (np.arange(n_faces) + 1) % n_verts, (np.arange(n_faces) + 2) % n_verts], axis=1
    ).astype(np.int64)
    t = lambda a: torch.as_tensor(a, device=dev)
    return FlameModel(t(v_template), t(shapedirs), t(posedirs), t(J_regressor), t(lbs_weights), parents, faces)


def full_pose(pose_params: torch.Tensor, ignore_global_rot: bool = False) -> torch.Tensor:
    """(B, 6) = [global(3), jaw(3)] -> the (B, 15) axis-angle pose of the
    five joints, neck and eyes at zero (reference: utils/flame.py:180-200)."""
    B = pose_params.shape[0]
    z = pose_params.new_zeros((B, 3))
    head = z if ignore_global_rot else pose_params[:, :3]
    return torch.cat([head, z, pose_params[:, 3:], pose_params.new_zeros((B, 6))], dim=1)


def flame_forward(model: FlameModel, shape_params: torch.Tensor, expression_params: torch.Tensor,
                  pose_params: Optional[torch.Tensor] = None, ignore_global_rot: bool = False):
    """FLAME decode: (shape (B, 100), exp (B, 50), pose (B, 6)) -> vertices
    (B, V, 3). Returns (verts, None, None): the landmark outputs of the
    JAX version are not ported yet."""
    B = shape_params.shape[0]
    if pose_params is None:
        pose_params = shape_params.new_zeros((B, 6))
    betas = torch.cat([shape_params, expression_params], dim=1)
    verts, _ = lbs(betas, full_pose(pose_params, ignore_global_rot), model.v_template, model.shapedirs,
                   model.posedirs, model.J_regressor, model.parents, model.lbs_weights)
    return verts, None, None
