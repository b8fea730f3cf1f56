"""Linear blend skinning (the port of ``msmd_tpu/ops/lbs.py``;
reference: utils/lbs.py:141-371). betas = concat(shape, expression);
pose is per-joint axis-angle; returns (verts, posed_joints).
"""

from __future__ import annotations

import numpy as np
import torch

from msmd_tpu_torch.ops.rotations import batch_rodrigues


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, n_betas) x (V, 3, n_betas) -> (B, V, 3) offsets."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) and translation (..., 3, 1) -> (..., 4, 4)."""
    batch = R.shape[:-2]
    pad_R = torch.cat([R, R.new_zeros(batch + (1, 3))], dim=-2)
    pad_t = torch.cat([t, t.new_ones(batch + (1, 1))], dim=-2)
    return torch.cat([pad_R, pad_t], dim=-1)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray):
    """Accumulate the kinematic chain (reference: utils/lbs.py:317-371).
    Returns (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4))."""
    parents = np.asarray(parents)
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]], dim=1)
    transforms_mat = transform_mat(rot_mats, rel_joints[..., None])
    chain = [transforms_mat[:, 0]]
    for i in range(1, parents.shape[0]):
        chain.append(chain[parents[i]] @ transforms_mat[:, i])
    transforms = torch.stack(chain, dim=1)
    posed_joints = transforms[:, :, :3, 3]
    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    shifted = torch.einsum("bjmn,bjn->bjm", transforms, joints_homo)
    correction = torch.zeros_like(transforms)
    correction[:, :, :, 3] = shifted
    return posed_joints, transforms - correction


def lbs(betas, pose, v_template, shapedirs, posedirs, J_regressor, parents, lbs_weights):
    """Full linear blend skinning with axis-angle pose (reference:
    utils/lbs.py:141-223). Returns verts (B, V, 3), posed_joints (B, J, 3)."""
    batch_size = max(betas.shape[0], pose.shape[0])
    if v_template.ndim == 2:
        v_template = v_template[None]
    v_shaped = v_template + blend_shapes(betas, shapedirs)
    J = vertices2joints(J_regressor, v_shaped)
    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(batch_size, -1, 3, 3)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(batch_size, -1)
    v_posed = (pose_feature @ posedirs).reshape(batch_size, -1, 3) + v_shaped
    J_transformed, A = batch_rigid_transform(rot_mats, J, parents)
    T = torch.einsum("vj,bjmn->bvmn", lbs_weights, A)
    v_posed_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvmn,bvn->bvm", T[..., :3, :], v_posed_homo)
    return verts, J_transformed
