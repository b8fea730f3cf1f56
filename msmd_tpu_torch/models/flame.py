"""FLAME head model (the port of ``msmd_tpu/models/flame.py``; reference:
utils/flame.py:59-301): the vertex decode, the static and pose-dependent
(contour) landmarks, and the BFM / FLAME texture decoder.

The licensed ``generic_model.pkl`` is not shipped: ``load_flame`` reads it
where a user has it (chumpy-pickled arrays without chumpy, the shape basis
sliced to the reference's [:n_shape] + [300:300 + n_exp]), and
``synthetic_flame`` builds a random model with FLAME's joint tree and
buffer shapes from the same ``np.random.RandomState(seed)`` draws as the
JAX package, in its order (vertex buffers first, then the landmark
embedding), so both packages hold identical buffers for a seed.
The texture space is the user's file too (``load_flame_tex``).
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

import torch.nn.functional as F

from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.ops.lbs import lbs, vertices2landmarks
from msmd_tpu_torch.ops.rotations import batch_rodrigues, rot_mat_to_euler

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
    # the landmark embedding (None when the model has none)
    lmk_faces_idx: Optional[torch.Tensor] = None  # (51,)
    lmk_bary_coords: Optional[torch.Tensor] = None  # (51, 3)
    dynamic_lmk_faces_idx: Optional[torch.Tensor] = None  # (79, 17)
    dynamic_lmk_bary_coords: Optional[torch.Tensor] = None  # (79, 17, 3)
    full_lmk_faces_idx: Optional[torch.Tensor] = None  # (68,)
    full_lmk_bary_coords: Optional[torch.Tensor] = None  # (68, 3)

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @property
    def neck_kin_chain(self) -> np.ndarray:
        """Joint chain from the neck (1) to the root (reference:
        utils/flame.py:120-126)."""
        chain, idx = [], 1
        while idx != -1:
            chain.append(idx)
            idx = int(self.parents[idx])
        return np.asarray(chain)


@dataclass(frozen=True)
class FLAMEConfig:
    flame_model_path: Optional[str] = None
    n_shape: int = 100
    n_exp: int = 50
    n_tex: int = 50
    tex_type: str = "BFM"
    tex_path: Optional[str] = None
    flame_lmk_embedding_path: Optional[str] = None


class _ChumpylessUnpickler(pickle.Unpickler):
    """Unpickles FLAME's generic_model.pkl without chumpy: a chumpy.Ch
    becomes an object holding its pickled state (its array in ``.r`` or
    ``.x``)."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            class _Ch:
                def __setstate__(self, state):
                    self.__dict__.update(state)

            return _Ch
        if module == "scipy.sparse.csc" and name == "csc_matrix":
            from scipy.sparse import csc_matrix

            return csc_matrix
        return super().find_class(module, name)


def _to_np(a, dtype=np.float32) -> np.ndarray:
    if hasattr(a, "todense"):
        a = np.asarray(a.todense())
    if hasattr(a, "r"):  # chumpy
        a = a.r
    if "x" in getattr(a, "__dict__", {}):
        a = a.__dict__["x"]
    return np.asarray(a, dtype=dtype)


def load_flame(config: FLAMEConfig, device="cuda") -> FlameModel:
    """FLAME's buffers from generic_model.pkl (and the landmark embedding's
    .npy when given) on ``device``, the shape basis sliced to [:n_shape] +
    [300:300 + n_exp] (reference: utils/flame.py:78-80)."""
    dev = resolve_device(device)
    with open(config.flame_model_path, "rb") as f:
        data = _ChumpylessUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    shapedirs = _to_np(data["shapedirs"])
    shapedirs = np.concatenate([shapedirs[:, :, :config.n_shape], shapedirs[:, :, 300:300 + config.n_exp]], axis=2)
    posedirs = _to_np(data["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (P, V * 3)
    parents = _to_np(data["kintree_table"], np.int64)[0]
    parents[0] = -1
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    lmk = {}
    if config.flame_lmk_embedding_path:
        e = np.load(config.flame_lmk_embedding_path, allow_pickle=True, encoding="latin1")[()]
        lmk = dict(
            lmk_faces_idx=t(np.asarray(e["static_lmk_faces_idx"], np.int64)),
            lmk_bary_coords=t(np.asarray(e["static_lmk_bary_coords"], np.float32)),
            dynamic_lmk_faces_idx=t(_to_np(e["dynamic_lmk_faces_idx"], np.int64)),
            dynamic_lmk_bary_coords=t(_to_np(e["dynamic_lmk_bary_coords"], np.float32)),
            full_lmk_faces_idx=t(np.asarray(e["full_lmk_faces_idx"], np.int64).reshape(-1)),
            full_lmk_bary_coords=t(np.asarray(e["full_lmk_bary_coords"], np.float32).reshape(-1, 3)),
        )
    return FlameModel(t(_to_np(data["v_template"])), t(shapedirs), t(posedirs), t(_to_np(data["J_regressor"])),
                      t(_to_np(data["weights"])), parents, _to_np(data["f"], np.int64), **lmk)


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
    lmk_n = min(51, n_faces)
    bary = rng.rand(lmk_n, 3).astype(np.float32)
    bary /= bary.sum(axis=1, keepdims=True)
    full_n = min(68, n_faces)
    full_bary = rng.rand(full_n, 3).astype(np.float32)
    full_bary /= full_bary.sum(axis=1, keepdims=True)
    dyn_bary = rng.rand(79, min(17, n_faces), 3).astype(np.float32)
    dyn_bary /= dyn_bary.sum(axis=-1, keepdims=True)
    # the index draws in the order of the JAX package's FlameModel(...) arguments
    lmk_idx = rng.randint(0, n_faces, lmk_n)
    dyn_idx = rng.randint(0, n_faces, (79, min(17, n_faces)))
    full_idx = rng.randint(0, n_faces, full_n)
    t = lambda a: torch.as_tensor(a, device=dev)
    return FlameModel(t(v_template), t(shapedirs), t(posedirs), t(J_regressor), t(lbs_weights), parents, faces,
                      lmk_faces_idx=t(lmk_idx.astype(np.int64)), lmk_bary_coords=t(bary),
                      dynamic_lmk_faces_idx=t(dyn_idx.astype(np.int64)), dynamic_lmk_bary_coords=t(dyn_bary),
                      full_lmk_faces_idx=t(full_idx.astype(np.int64)), full_lmk_bary_coords=t(full_bary))


def full_pose(pose_params: torch.Tensor, ignore_global_rot: bool = False,
              eye_pose_params: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 6) = [global(3), jaw(3)] -> the (B, 15) axis-angle pose of the
    five joints, the neck at zero and the eyes at ``eye_pose_params``
    (zero when None) (reference: utils/flame.py:180-200)."""
    B = pose_params.shape[0]
    z = pose_params.new_zeros((B, 3))
    head = z if ignore_global_rot else pose_params[:, :3]
    eyes = pose_params.new_zeros((B, 6)) if eye_pose_params is None else eye_pose_params
    return torch.cat([head, z, pose_params[:, 3:], eyes], dim=1)


def _full_pose_matrices(B: int, like: torch.Tensor, pose_params: Optional[torch.Tensor], ignore_global_rot: bool,
                        eye_pose_params: Optional[torch.Tensor]) -> torch.Tensor:
    """The (B, 45) pose of the five joints as flattened 3x3 matrices:
    [global(9), neck = I, jaw(9), eyes(18)], the identity where a part is
    None or ignored (``pose2rot=False``, ``msmd_tpu/models/flame.py``:287-294)."""
    eye = torch.eye(3, dtype=like.dtype, device=like.device).reshape(1, 9).expand(B, 9)
    if pose_params is None:
        pose_params = torch.cat([eye, eye], dim=1)
    if eye_pose_params is None:
        eye_pose_params = torch.cat([eye, eye], dim=1)
    head = eye if ignore_global_rot else pose_params[:, :9]
    return torch.cat([head, eye, pose_params[:, 9:], eye_pose_params], dim=1)


def _find_dynamic_lmk_idx_and_bcoords(model: FlameModel, pose: torch.Tensor):
    """The contour landmarks chosen by the neck chain's rotation about y
    (reference: utils/flame.py:128-172): the chain's axis-angle rows of the
    full pose through Rodrigues, their product, the y angle in degrees
    capped at 39 and rounded (half to even, as ``jnp.round``), negative
    angles mapped to 39 - angle (78 below -39). Like the JAX package, it
    reads the full pose's rows of three as axis-angle whatever ``pose2rot``
    was. Returns the (B, 17) face indices and (B, 17, 3) weights."""
    B = pose.shape[0]
    chain = model.neck_kin_chain
    aa_pose = pose.reshape(B, -1, 3)[:, chain]
    rot_mats = batch_rodrigues(aa_pose.reshape(-1, 3)).reshape(B, -1, 3, 3)
    rel_rot_mat = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(B, 3, 3)
    for idx in range(len(chain)):
        rel_rot_mat = rot_mats[:, idx] @ rel_rot_mat
    y_rot_angle = torch.round(torch.clamp(rot_mat_to_euler(rel_rot_mat) * 180.0 / np.pi, max=39)).to(torch.int32)
    neg_mask = (y_rot_angle < 0).to(torch.int32)
    mask = (y_rot_angle < -39).to(torch.int32)
    neg_vals = mask * 78 + (1 - mask) * (39 - y_rot_angle)
    y_rot_angle = (neg_mask * neg_vals + (1 - neg_mask) * y_rot_angle).long()
    return model.dynamic_lmk_faces_idx[y_rot_angle], model.dynamic_lmk_bary_coords[y_rot_angle]


def flame_forward(model: FlameModel, shape_params: torch.Tensor, expression_params: torch.Tensor,
                  pose_params: Optional[torch.Tensor] = None, eye_pose_params: Optional[torch.Tensor] = None,
                  pose2rot: bool = True, ignore_global_rot: bool = False, return_lm2d: bool = False,
                  return_lm3d: bool = False):
    """FLAME decode (reference: utils/flame.py:180-244): shape (B, 100), exp
    (B, 50), pose (B, 6) = [global(3), jaw(3)] axis-angle (or (B, 18) of
    two flattened matrices with ``pose2rot=False``) -> (vertices (B, V, 3),
    lm2d, lm3d). The neck is fixed at zero and the eyes default to zero.
    ``return_lm2d``: the 17 contour landmarks chosen by the head's y
    rotation, then the 51 static ones (B, 68, 3); ``return_lm3d``: the 68
    full landmarks; each None when not asked for."""
    B = shape_params.shape[0]
    betas = torch.cat([shape_params, expression_params], dim=1)
    if pose2rot:
        if pose_params is None:
            pose_params = shape_params.new_zeros((B, 6))
        pose = full_pose(pose_params, ignore_global_rot, eye_pose_params)
    else:
        pose = _full_pose_matrices(B, shape_params, pose_params, ignore_global_rot, eye_pose_params)
    verts, _ = lbs(betas, pose, model.v_template, model.shapedirs, model.posedirs, model.J_regressor,
                   model.parents, model.lbs_weights, pose2rot=pose2rot)
    lm2d = lm3d = None
    if return_lm2d:
        dyn_idx, dyn_bary = _find_dynamic_lmk_idx_and_bcoords(model, pose)
        lmk_idx = torch.cat([dyn_idx, model.lmk_faces_idx[None].expand(B, -1)], dim=1)
        lmk_bary = torch.cat([dyn_bary, model.lmk_bary_coords[None].expand(B, -1, -1)], dim=1)
        lm2d = vertices2landmarks(verts, model.faces, lmk_idx, lmk_bary)
    if return_lm3d:
        lm3d = select_3d68(model, verts)
    return verts, lm2d, lm3d


def select_3d68(model: FlameModel, vertices: torch.Tensor) -> torch.Tensor:
    """The 68 full landmarks of (B, V, 3) vertices (reference:
    utils/flame.py:174-178)."""
    return vertices2landmarks(vertices, model.faces, model.full_lmk_faces_idx, model.full_lmk_bary_coords)


# ---------------------------------------------------------------------------
# texture decoder (reference: utils/flame.py:247-301)
# ---------------------------------------------------------------------------

def load_flame_tex(config: FLAMEConfig, device="cuda"):
    """The BFM-to-FLAME (``tex_type="BFM"``) or FLAME texture basis from
    ``config.tex_path`` on ``device``: (mean (1, N), basis (N, n_tex)), f32,
    the FLAME layout scaled by 255."""
    dev = resolve_device(device)
    tex_space = np.load(config.tex_path)
    if config.tex_type == "BFM":
        mu_key, pc_key, scale = "MU", "PC", 1.0
    elif config.tex_type == "FLAME":
        mu_key, pc_key, scale = "mean", "tex_dir", 255.0
    else:
        raise ValueError(f"Texture type {config.tex_type} not supported")
    mean = np.reshape(tex_space[mu_key], (1, -1)) * scale
    basis = np.reshape(tex_space[pc_key], (-1, 199))[:, :config.n_tex] * scale
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=dev)
    return t(mean), t(basis)


def flame_tex_forward(texture_mean: torch.Tensor, texture_basis: torch.Tensor, texcode: torch.Tensor,
                      size: int = 512) -> torch.Tensor:
    """Texture decode: texcode (B, n_tex) -> (B, 3, size, size) RGB in [0, 1]
    with the reference's BGR-to-RGB flip. The basis product is one large
    product (``torch.matmul``, as the JAX package leaves it to XLA). Another
    size than 512 is a bilinear resample that antialiases when it shrinks,
    ``jax.image.resize(method="bilinear")``'s triangle filter (within 4e-7
    of it on the CPU)."""
    texture = texture_mean + (texture_basis @ texcode.T).T  # (B, N)
    B = texcode.shape[0]
    texture = texture.reshape(B, 512, 512, 3).flip(-1) / 255.0
    texture = texture.permute(0, 3, 1, 2)
    if size != 512:
        texture = F.interpolate(texture, size=(size, size), mode="bilinear", align_corners=False, antialias=True)
    return texture
