"""Fused FLAME vertex decode: a hand-written CUDA kernel (``csrc/lbs.cu``),
its plain PyTorch version, and the buffers they share.

Replaces the forward of ``msmd_tpu/ops/pallas/lbs_kernel.py::
flame_vertices_fused``: blendshapes as ``template + betas_ext @ dirs`` per
coordinate, then 5-joint skinning ``sum_j W[v, j] (R_j p + t_j)`` with no
per-vertex transform materialised. The kinematic chain (Rodrigues on the
joint rotations, the 5-node rigid transform) is O(N * 5) work and stays in
plain torch, as the JAX package keeps it in jnp. The kernel runs the blend
product on the tensor cores at f32 accuracy as three TF32 products
(3xTF32: each operand split into hi and lo TF32 parts, lo.hi + hi.lo +
hi.hi summed in f32): ``tf32_split_plain`` and ``skin_tf32_plain`` model
that arithmetic on the CPU, ``lbs_plan`` picks the kernel's tiles.

The gradient (``FlameSkin``, the port of ``FusedFlame.skin_fn``'s custom
VJP, ``msmd_tpu/ops/pallas/lbs_kernel.py``:80-108) recomputes the posed
planes and forms ``d_betas = dv . dirs^T`` with f32 ``torch.matmul``, as
JAX leaves them to jnp einsums; its skinning terms (``dv``, ``dR``, ``dt``)
are the kernel K5 bwd (``csrc/lbs_bwd.cu``) on the card and
``skin_vjp_plain`` on the CPU.
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
from msmd_tpu_torch.utils.profiling import span

N_JOINTS = 5
LBS_KSTEP = 16  # basis rows a k-step of the kernel: KB is padded to a multiple
LBS_FRAMES = 128  # frames a tile
LBS_VERTICES = 64  # vertices a tile: n = 3 x 64 = 192 a wgmma
H100_SMS = 132


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tf32_split_plain(x: torch.Tensor):
    """(hi, lo) of an f32 tensor: hi = x rounded to TF32 (10 mantissa bits,
    to nearest, ties away from zero: ``cvt.rna.tf32.f32``), lo = x - hi
    rounded the same way; |x - hi - lo| <= 2^-22 |x| for normal x."""

    def rna(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


class FusedFlame:
    """Kernel-friendly FLAME buffers on the model's device.

    - ``dirs`` (3, n_basis, Vp): [shapedirs | posedirs] per coordinate,
      vertices padded to a multiple of ``lane`` (the plain version's layout,
      and the K-major one of a product that contracts over vertices)
    - ``dirs_hi``, ``dirs_lo`` (3, Vp, kbp): ``dirs`` K-major, the basis
      rows padded with zeros to ``kbp`` (a multiple of ``LBS_KSTEP``), split
      into TF32 parts (``tf32_split_plain``): the kernel's B operand
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
        self.kbp = _round_up(self.n_basis, LBS_KSTEP)
        km = F.pad(self.dirs.transpose(1, 2), (0, self.kbp - self.n_basis))  # (3, Vp, kbp)
        self.dirs_hi, self.dirs_lo = (t.contiguous() for t in tf32_split_plain(km))
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


def _skin(fused: FusedFlame, planes: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """The skinning of posed planes (3, N, Vp) with rt (N, 60) -> (N, V, 3)."""
    N = planes.shape[1]
    R = rt.reshape(N, N_JOINTS, 12)
    out = torch.zeros_like(planes)
    for j in range(N_JOINTS):
        w = fused.weights_t[j][None, :]
        for d in range(3):
            r = R[:, j, 4 * d: 4 * d + 4]
            row = r[:, 0:1] * planes[0] + r[:, 1:2] * planes[1] + r[:, 2:3] * planes[2] + r[:, 3:4]
            out[d] = out[d] + w * row
    return out.permute(1, 2, 0)[:, : fused.n_verts]


def skin_plain(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: (N, n_basis), (N, 60) -> (N, V, 3)."""
    planes = fused.template[:, None, :] + torch.einsum("bk,ckv->cbv", betas_ext, fused.dirs)  # (3, N, Vp)
    return _skin(fused, planes, rt)


def skin_tf32_plain(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The kernel's arithmetic on any device: the blend product from the
    TF32 parts of betas_ext and of ``dirs_hi`` / ``dirs_lo``, each part
    product exact in f32 and summed in f32, lo.hi + hi.lo + hi.hi
    (``passes=3``, the kernel) or hi.hi alone (``passes=1``, one TF32
    product), then the skinning."""
    a_hi, a_lo = tf32_split_plain(F.pad(betas_ext, (0, fused.kbp - fused.n_basis)))
    prod = lambda a, d: torch.einsum("bk,cvk->cbv", a, d)
    blend = prod(a_hi, fused.dirs_hi)
    if passes == 3:
        blend = (prod(a_lo, fused.dirs_hi) + prod(a_hi, fused.dirs_lo)) + blend
    elif passes != 1:
        raise ValueError(f"skin_tf32_plain: passes must be 1 or 3, got {passes}")
    return _skin(fused, fused.template[:, None, :] + blend, rt)


def lbs_plan(N: int, V: int, sms: int = H100_SMS) -> dict:
    """The kernel's tiles for N frames and V vertices on ``sms`` SMs: tiles of
    ``LBS_FRAMES`` frames by ``LBS_VERTICES`` vertices, frames fastest, on a
    persistent grid of min(tiles, sms) blocks, block b taking tiles b, b +
    grid, .... Two launches: the betas split, then the kernel."""
    if N <= 0 or V <= 0:
        raise ValueError(f"lbs_plan: N and V must be positive, got {N}, {V}")
    frame_tiles, vertex_tiles = -(-N // LBS_FRAMES), -(-V // LBS_VERTICES)
    tiles = frame_tiles * vertex_tiles
    return {"vw": LBS_VERTICES, "frames": LBS_FRAMES, "frame_tiles": frame_tiles, "vertex_tiles": vertex_tiles,
            "tiles": tiles, "grid": min(tiles, sms), "launches": 2}


def _lib():
    lib = _build.load("lbs")
    if not getattr(lib, "_msmd_typed", False):
        lib.msmd_lbs_forward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
        lib.msmd_lbs_forward.restype = ctypes.c_int
        lib._msmd_typed = True
    return lib


def _bwd_lib():
    lib = _build.load("lbs_bwd")
    if not getattr(lib, "_msmd_typed", False):
        lib.msmd_lbs_backward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.msmd_lbs_backward.restype = ctypes.c_int
        lib.msmd_lbs_bwd_tile.restype = ctypes.c_int
        lib._msmd_typed = True
    return lib


def _launch(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor, stamps: bool):
    N, dev = betas_ext.shape[0], betas_ext.device
    named = dict(betas_ext=(betas_ext, (N, fused.n_basis)), rt=(rt, (N, N_JOINTS * 12)),
                 dirs_hi=(fused.dirs_hi, (3, fused.vp, fused.kbp)), dirs_lo=(fused.dirs_lo, (3, fused.vp, fused.kbp)),
                 template=(fused.template, (3, fused.vp)), weights_t=(fused.weights_t, (N_JOINTS, fused.vp)))
    for name, (t, shape) in named.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flame_vertices: {name} must be on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flame_vertices: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"flame_vertices: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"flame_vertices: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flame_vertices: {name} must be 16-byte aligned")
    plan = lbs_plan(N, fused.n_verts, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _lib()
    ws = torch.empty(2, N, fused.kbp, dtype=torch.float32, device=dev)
    out = torch.empty(N, fused.n_verts, 3, dtype=torch.float32, device=dev)
    st = torch.zeros(plan["grid"], 3, dtype=torch.int64, device=dev) if stamps else None
    rc = lib.msmd_lbs_forward(
        _build.ptr(betas_ext), _build.ptr(rt), _build.ptr(fused.dirs_hi), _build.ptr(fused.dirs_lo),
        _build.ptr(fused.template), _build.ptr(fused.weights_t), _build.ptr(ws), _build.ptr(out),
        N, fused.n_basis, fused.kbp, fused.n_verts, fused.vp, plan["grid"],
        _build.ptr(st) if stamps else None, _build.stream(dev),
    )
    _build.check(lib, rc, "flame_vertices")
    return out, st


def skin_cuda(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (N, n_basis), (N, 60) f32 on the card -> (N, V, 3)."""
    return _launch(fused, betas_ext, rt, stamps=False)[0]


def lbs_stamps(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """One launch with the card's clock recorded: (grid, 3) int64, each
    block's nanoseconds in its main loops, in its epilogues (then ending
    in a block barrier) and in all."""
    return _launch(fused, betas_ext, rt, stamps=True)[1]


def skin_vjp_plain(fused: FusedFlame, planes: torch.Tensor, rt: torch.Tensor, g: torch.Tensor):
    """The skinning terms of the VJP (JAX's ``bwd``, term for term): posed
    planes (3, N, Vp), rt (N, 60) and the output's cotangent g (N, V, 3)
    -> (dv (3, N, Vp), d_rt (N, 60))."""
    N = rt.shape[0]
    gp = F.pad(g.permute(2, 0, 1), (0, fused.vp - fused.n_verts))  # (3, N, Vp)
    R = rt.reshape(N, N_JOINTS, 3, 4)[..., :3]
    gw = torch.einsum("dbv,jv->dbvj", gp, fused.weights_t)  # (3, N, Vp, J)
    dv = torch.einsum("dbvj,bjdc->cbv", gw, R)
    dR = torch.einsum("dbvj,cbv->bjdc", gw, planes)
    dt = torch.einsum("dbvj->bjd", gw)
    return dv, torch.cat([dR, dt[..., None]], dim=-1).reshape(N, N_JOINTS * 12)


def skin_vjp_cuda(fused: FusedFlame, planes: torch.Tensor, rt: torch.Tensor, g: torch.Tensor):
    """Launch K5 bwd: ``skin_vjp_plain``'s function on f32 card tensors."""
    N, V, vp, dev = rt.shape[0], fused.n_verts, fused.vp, rt.device
    _build.check_args("skin_backward", dev, g=(g, (N, V, 3), torch.float32),
                      planes=(planes, (3, N, vp), torch.float32), rt=(rt, (N, N_JOINTS * 12), torch.float32),
                      weights_t=(fused.weights_t, (N_JOINTS, vp), torch.float32))
    lib = _bwd_lib()
    tiles = -(-vp // lib.msmd_lbs_bwd_tile())
    dv = torch.empty(3, N, vp, dtype=torch.float32, device=dev)
    part = torch.empty(N, tiles, N_JOINTS * 12, dtype=torch.float32, device=dev)
    d_rt = torch.empty(N, N_JOINTS * 12, dtype=torch.float32, device=dev)
    rc = lib.msmd_lbs_backward(_build.ptr(g), _build.ptr(planes), _build.ptr(rt), _build.ptr(fused.weights_t),
                               _build.ptr(dv), _build.ptr(part), _build.ptr(d_rt), N, V, vp, tiles,
                               _build.stream(dev))
    _build.check(lib, rc, "skin_backward")
    return dv, d_rt


def posed_planes(fused: FusedFlame, betas_ext: torch.Tensor) -> torch.Tensor:
    """template + betas_ext . dirs: the posed planes (3, N, Vp), f32."""
    return (fused.template[:, None, :] + torch.einsum("bk,ckv->cbv", betas_ext, fused.dirs)).contiguous()


def skin_backward_plain(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor, g: torch.Tensor):
    """The VJP of the skinning in plain torch: (d_betas (N, n_basis), d_rt (N, 60))."""
    dv, d_rt = skin_vjp_plain(fused, posed_planes(fused, betas_ext), rt, g)
    return torch.einsum("cbv,ckv->bk", dv, fused.dirs), d_rt


def skin_backward(fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor, g: torch.Tensor):
    """The VJP of the skinning: the planes and d_betas by f32 products, the
    skinning terms by K5 bwd on the card (or its plain version on the CPU)."""
    if _build.on_cpu("skin_backward", betas_ext):
        return skin_backward_plain(fused, betas_ext, rt, g)
    dv, d_rt = skin_vjp_cuda(fused, posed_planes(fused, betas_ext), rt, g.contiguous())
    skin_backward.launches += 1
    return torch.einsum("cbv,ckv->bk", dv, fused.dirs), d_rt


skin_backward.launches = 0


class FlameSkin(torch.autograd.Function):
    """(betas_ext (N, n_basis), rt (N, 60)) -> verts (N, V, 3): K5 forward
    on the card (``skin_plain`` on the CPU), ``skin_backward`` as its VJP."""

    @staticmethod
    def forward(ctx, fused: FusedFlame, betas_ext: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
        ctx.fused = fused
        ctx.save_for_backward(betas_ext, rt)
        if _build.on_cpu("flame_vertices", betas_ext):
            return skin_plain(fused, betas_ext, rt)
        out = skin_cuda(fused, betas_ext, rt)
        flame_vertices.launches += 1
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        betas_ext, rt = ctx.saved_tensors
        d_betas, d_rt = skin_backward(ctx.fused, betas_ext, rt, g.float())
        return None, d_betas, d_rt


def flame_vertices_plain(fused: FusedFlame, shape_params, expression_params, pose_params=None,
                         ignore_global_rot: bool = False) -> torch.Tensor:
    """``flame_vertices`` with the skinning in plain torch (under torch autograd)."""
    betas_ext, rt = skin_inputs(fused, shape_params, expression_params, pose_params, ignore_global_rot)
    return skin_plain(fused, betas_ext, rt)


def flame_vertices(fused: FusedFlame, shape_params: torch.Tensor, expression_params: torch.Tensor,
                   pose_params: Optional[torch.Tensor] = None, ignore_global_rot: bool = False) -> torch.Tensor:
    """(shape (N, 100), exp (N, 50), pose (N, 6)) -> verts (N, V, 3); the
    signature of ``flame_vertices_fused``, differentiable in all three
    (``FlameSkin``). Tensors on the CPU take the plain versions; tensors on
    the card launch the kernels or raise."""
    with span("msmd.flame.decode"):
        betas_ext, rt = skin_inputs(fused, shape_params, expression_params, pose_params, ignore_global_rot)
        return FlameSkin.apply(fused, betas_ext, rt)


flame_vertices.launches = 0
