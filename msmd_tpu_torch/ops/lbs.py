"""Linear blend skinning and barycentric landmarks (the port of
``msmd_tpu/ops/lbs.py``; reference: utils/lbs.py:100-371). betas =
concat(shape, expression); pose is per-joint axis-angle
(``pose2rot=True``) or flattened 3x3 matrices; ``lbs`` returns (verts,
posed_joints).
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


def lbs(betas, pose, v_template, shapedirs, posedirs, J_regressor, parents, lbs_weights, pose2rot: bool = True):
    """Full linear blend skinning (reference: utils/lbs.py:141-223). pose
    is (B, J * 3) axis-angle, or (B, J * 9) rotation matrices with
    ``pose2rot=False``. Returns verts (B, V, 3), posed_joints (B, J, 3)."""
    batch_size = max(betas.shape[0], pose.shape[0])
    if v_template.ndim == 2:
        v_template = v_template[None]
    v_shaped = v_template + blend_shapes(betas, shapedirs)
    J = vertices2joints(J_regressor, v_shaped)
    if pose2rot:
        rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(batch_size, -1, 3, 3)
    else:
        rot_mats = pose.reshape(batch_size, -1, 3, 3)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(batch_size, -1)
    v_posed = (pose_feature @ posedirs).reshape(batch_size, -1, 3) + v_shaped
    J_transformed, A = batch_rigid_transform(rot_mats, J, parents)
    T = torch.einsum("vj,bjmn->bvmn", lbs_weights, A)
    v_posed_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvmn,bvn->bvm", T[..., :3, :], v_posed_homo)
    return verts, J_transformed


def vertices2landmarks(vertices: torch.Tensor, faces, lmk_faces_idx: torch.Tensor,
                       lmk_bary_coords: torch.Tensor) -> torch.Tensor:
    """Barycentric landmark interpolation (reference: utils/lbs.py:100-137):
    vertices (B, V, 3), faces (F, 3) int, lmk_faces_idx (B, L) or (L,),
    lmk_bary_coords (B, L, 3) or (L, 3) -> (B, L, 3)."""
    B = vertices.shape[0]
    faces = torch.as_tensor(faces, device=vertices.device)
    if lmk_faces_idx.ndim == 1:
        lmk_faces_idx = lmk_faces_idx[None].expand(B, -1)
    if lmk_bary_coords.ndim == 2:
        lmk_bary_coords = lmk_bary_coords[None].expand(B, -1, -1)
    flat_idx = faces[lmk_faces_idx.to(vertices.device)].reshape(B, -1)  # (B, L * 3) vertex ids
    lmk_vertices = torch.gather(vertices, 1, flat_idx[..., None].expand(-1, -1, 3)).reshape(B, -1, 3, 3)
    return torch.einsum("blfi,blf->bli", lmk_vertices, lmk_bary_coords.to(vertices.dtype))
