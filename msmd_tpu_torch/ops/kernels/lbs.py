"""Fused FLAME vertex decode: a hand-written CUDA kernel (``csrc/lbs.cu``),
its plain PyTorch version, and the buffers they share.

Replaces the forward of ``msmd_tpu/ops/pallas/lbs_kernel.py::
flame_vertices_fused``: blendshapes as ``template + betas_ext @ dirs`` per
coordinate, then 5-joint skinning ``sum_j W[v, j] (R_j p + t_j)`` with no
per-vertex transform materialised. The kinematic chain (Rodrigues on the
joint rotations, the 5-node rigid transform) is O(N * 5) work and stays in
plain torch, as the JAX package keeps it in jnp. The kernel works in f32
throughout (no TF32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from msmd_tpu_torch import _build
from msmd_tpu_torch.models.flame import FlameModel, full_pose
from msmd_tpu_torch.ops.lbs import batch_rigid_transform, vertices2joints
from msmd_tpu_torch.ops.rotations import batch_rodrigues

N_JOINTS = 5


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class FusedFlame:
    """Kernel-friendly FLAME buffers on the model's device.

    - ``dirs`` (3, n_basis, Vp): [shapedirs | posedirs] per coordinate,
      vertices padded to a multiple of ``lane``
    - ``template`` (3, Vp) and ``weights_t`` (N_JOINTS, Vp)
    - ``j_template`` (J, 3), ``j_dirs`` (S, J, 3): the joint regressor
      reduced to the betas, so the shaped mesh is never built
    """

    def __init__(self, model: FlameModel, lane: int = 128):
        self.model = model
        V = model.n_verts
        self.n_verts = V
        self.vp = _round_up(V, lane)
        n_pose = model.posedirs.shape[0]
        sd = model.shapedirs.permute(1, 2, 0)  # (3, S, V)
        pd = model.posedirs.reshape(n_pose, V, 3).permute(2, 0, 1)  # (3, P, V)
        pad = self.vp - V
        self.dirs = F.pad(torch.cat([sd, pd], dim=1), (0, pad)).contiguous()
        self.n_basis = self.dirs.shape[1]
        self.template = F.pad(model.v_template.t(), (0, pad)).contiguous()
        self.weights_t = F.pad(model.lbs_weights.t(), (0, pad)).contiguous()
        self.j_template = vertices2joints(model.J_regressor, model.v_template[None])[0]
        self.j_dirs = torch.einsum("jv,vck->kjc", model.J_regressor, model.shapedirs)


def skin_inputs(fused: FusedFlame, shape_params, expression_params, pose_params=None,
                ignore_global_rot: bool = False):
    """(betas_ext (N, n_basis), rt (N, 60)) for the skinning, in f32."""
    B = shape_params.shape[0]
    if pose_params is None:
        pose_params = shape_params.new_zeros((B, 6))
    betas = torch.cat([shape_params, expression_params], dim=1)
    rot_mats = batch_rodrigues(full_pose(pose_params, ignore_global_rot).reshape(-1, 3)).reshape(B, -1, 3, 3)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    betas_ext = torch.cat([betas, pose_feature], dim=1).float().contiguous()
    J = fused.j_template[None] + torch.einsum("bk,kjc->bjc", betas, fused.j_dirs)
    _, A = batch_rigid_transform(rot_mats, J, fused.model.parents)
    rt = A[:, :, :3, :].reshape(B, N_JOINTS * 12).float().contiguous()
    return betas_ext, rt


def skin_plain(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: (N, n_basis), (N, 60) -> (N, V, 3)."""
    N = betas_ext.shape[0]
    planes = fused.template[:, None, :] + torch.einsum("bk,ckv->cbv", betas_ext, fused.dirs)  # (3, N, Vp)
    R = rt.reshape(N, N_JOINTS, 12)
    out = torch.zeros_like(planes)
    for j in range(N_JOINTS):
        w = fused.weights_t[j][None, :]
        for d in range(3):
            r = R[:, j, 4 * d: 4 * d + 4]
            row = r[:, 0:1] * planes[0] + r[:, 1:2] * planes[1] + r[:, 2:3] * planes[2] + r[:, 3:4]
            out[d] = out[d] + w * row
    return out.permute(1, 2, 0)[:, : fused.n_verts]


def _lib():
    lib = _build.load("lbs")
    if not getattr(lib, "_msmd_typed", False):
        lib.msmd_lbs_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.msmd_lbs_forward.restype = ctypes.c_int
        lib._msmd_typed = True
    return lib


def skin_cuda(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (N, n_basis), (N, 60) f32 on the card -> (N, V, 3)."""
    N = betas_ext.shape[0]
    named = dict(betas_ext=(betas_ext, (N, fused.n_basis)), rt=(rt, (N, N_JOINTS * 12)),
                 dirs=(fused.dirs, (3, fused.n_basis, fused.vp)), template=(fused.template, (3, fused.vp)),
                 weights_t=(fused.weights_t, (N_JOINTS, fused.vp)))
    for name, (t, shape) in named.items():
        if t.device.type != "cuda" or t.device != betas_ext.device:
            raise ValueError(f"flame_vertices: {name} must be on {betas_ext.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flame_vertices: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"flame_vertices: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"flame_vertices: {name} must be contiguous")
    lib = _lib()
    out = torch.empty(N, fused.n_verts, 3, dtype=torch.float32, device=betas_ext.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = lib.msmd_lbs_forward(
        ptr(betas_ext), ptr(rt), ptr(fused.dirs), ptr(fused.template), ptr(fused.weights_t), ptr(out),
        N, fused.n_basis, fused.n_verts, fused.vp,
        ctypes.c_void_p(torch.cuda.current_stream(betas_ext.device).cuda_stream),
    )
    _build.check(lib, rc, "flame_vertices")
    return out


def flame_vertices_plain(fused: FusedFlame, shape_params, expression_params, pose_params=None,
                         ignore_global_rot: bool = False) -> torch.Tensor:
    """``flame_vertices`` with the skinning in plain torch."""
    betas_ext, rt = skin_inputs(fused, shape_params, expression_params, pose_params, ignore_global_rot)
    return skin_plain(fused, betas_ext, rt)


def flame_vertices(fused: FusedFlame, shape_params: torch.Tensor, expression_params: torch.Tensor,
                   pose_params: Optional[torch.Tensor] = None, ignore_global_rot: bool = False) -> torch.Tensor:
    """(shape (N, 100), exp (N, 50), pose (N, 6)) -> verts (N, V, 3); the
    signature of ``flame_vertices_fused``. Tensors on the CPU take the
    plain version; tensors on the card launch the kernel or raise."""
    betas_ext, rt = skin_inputs(fused, shape_params, expression_params, pose_params, ignore_global_rot)
    if betas_ext.device.type == "cpu":
        return skin_plain(fused, betas_ext, rt)
    if betas_ext.device.type != "cuda":
        raise ValueError(f"flame_vertices: unsupported device {betas_ext.device}")
    out = skin_cuda(fused, betas_ext, rt)
    flame_vertices.launches += 1
    return out


flame_vertices.launches = 0
