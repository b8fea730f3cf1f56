"""FLAME head model, vertices only (the port of part of
``msmd_tpu/models/flame.py``; reference: utils/flame.py:59-244).

The licensed ``generic_model.pkl`` is not shipped: ``load_flame`` reads it
where a user has it (chumpy-pickled arrays without chumpy, the shape basis
sliced to the reference's [:n_shape] + [300:300 + n_exp]), and
``synthetic_flame`` builds a random model with FLAME's joint tree and
buffer shapes from the same ``np.random.RandomState(seed)`` draws as the
JAX package, so both packages hold identical buffers for a seed.
``load_flame`` keeps the landmark embedding's arrays when given one, but
the landmark outputs are not ported: ``flame_forward`` returns None for
them.
"""

from __future__ import annotations

import io
import pickle
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
    # the landmark embedding, kept for the landmark outputs (not ported)
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


@dataclass(frozen=True)
class FLAMEConfig:
    flame_model_path: Optional[str] = None
    n_shape: int = 100
    n_exp: int = 50
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
