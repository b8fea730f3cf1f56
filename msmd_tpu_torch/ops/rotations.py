"""Rotation-representation conversions in the PyTorch3D convention (the
port of ``msmd_tpu/ops/rotations.py``; reference:
utils/rotation_conversions.py:38-568 and the Rodrigues kernel of
utils/lbs.py:270-301).

Every function is batched over leading dims and differentiable, with the
JAX package's regularisation: ``_sqrt_positive_part`` and ``_safe_norm``
keep a finite gradient at 0 by the double-``where`` trick, and
``_copysign`` is a ``where`` on the sign. Quaternions are (w, x, y, z).
The random draws take a ``torch.Generator`` where the JAX package takes
a key, so the two packages draw different numbers from the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch


# --------------------------------------------------------------------------
# quaternion <-> matrix
# --------------------------------------------------------------------------

def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    r, i, j, k = torch.unbind(quaternions, -1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b < 0, -a.abs(), a.abs())


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x <= 0."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.sqrt(safe), torch.zeros_like(x))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz."""
    m00, m11, m22 = matrix[..., 0, 0], matrix[..., 1, 1], matrix[..., 2, 2]
    o0 = 0.5 * _sqrt_positive_part(1 + m00 + m11 + m22)
    x = 0.5 * _sqrt_positive_part(1 + m00 - m11 - m22)
    y = 0.5 * _sqrt_positive_part(1 - m00 + m11 - m22)
    z = 0.5 * _sqrt_positive_part(1 - m00 - m11 + m22)
    o1 = _copysign(x, matrix[..., 2, 1] - matrix[..., 1, 2])
    o2 = _copysign(y, matrix[..., 0, 2] - matrix[..., 2, 0])
    o3 = _copysign(z, matrix[..., 1, 0] - matrix[..., 0, 1])
    return torch.stack([o0, o1, o2, o3], dim=-1)


# --------------------------------------------------------------------------
# euler <-> matrix
# --------------------------------------------------------------------------

def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError("letter must be either X, Y or Z.")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3) radians in ``convention`` (e.g. 'XYZ') -> (..., 3, 3),
    R = R_c0(a0) @ R_c1(a1) @ R_c2(a2)."""
    if len(convention) != 3:
        raise ValueError("Convention must have 3 letters.")
    if euler_angles.shape[-1] != 3:
        raise ValueError("Invalid input euler angles.")
    m = [_axis_angle_rotation(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return m[0] @ m[1] @ m[2]


def _index_from_letter(letter: str) -> int:
    return "XYZ".index(letter)


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) radians in ``convention``."""
    if len(convention) != 3:
        raise ValueError("Convention must have 3 letters.")
    i0, i2 = _index_from_letter(convention[0]), _index_from_letter(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in (-1, 2) else 1.0
        central_angle = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1.0, 1.0))
    else:
        central_angle = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central_angle,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)


# --------------------------------------------------------------------------
# random rotations
# --------------------------------------------------------------------------

def random_quaternions(generator: Optional[torch.Generator], n: int, dtype=torch.float32) -> torch.Tensor:
    """n unit quaternions, uniform over the rotations, drawn from
    ``generator`` (on its device; the default generator when None)."""
    device = generator.device if generator is not None else None
    o = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    return o / torch.linalg.norm(o, dim=-1, keepdim=True)


def random_rotations(generator: Optional[torch.Generator], n: int, dtype=torch.float32) -> torch.Tensor:
    return quaternion_to_matrix(random_quaternions(generator, n, dtype))


def random_rotation(generator: Optional[torch.Generator], dtype=torch.float32) -> torch.Tensor:
    return random_rotations(generator, 1, dtype)[0]


# --------------------------------------------------------------------------
# quaternion algebra
# --------------------------------------------------------------------------

def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Force w >= 0 (q and -q denote the same rotation)."""
    return torch.where(quaternions[..., 0:1] < 0, -quaternions, quaternions)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    return torch.stack([ow, ox, oy, oz], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    return quaternion * quaternion.new_tensor([1, -1, -1, -1])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) points by (..., 4) quaternions."""
    if point.shape[-1] != 3:
        raise ValueError(f"Points are not in 3D, {tuple(point.shape)}.")
    real_parts = point.new_zeros(point.shape[:-1] + (1,))
    point_as_quaternion = torch.cat([real_parts, point], dim=-1)
    out = quaternion_raw_multiply(quaternion_raw_multiply(quaternion, point_as_quaternion),
                                  quaternion_invert(quaternion))
    return out[..., 1:]


# --------------------------------------------------------------------------
# axis-angle
# --------------------------------------------------------------------------

def _safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True, eps: float = 1e-12) -> torch.Tensor:
    """Norm with a finite gradient at 0 (sqrt'(0) is inf, so a plain norm
    gives NaN gradients at the origin; the double ``where`` keeps both
    branches finite)."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    safe = torch.where(sq > eps, sq, torch.ones_like(sq))
    return torch.where(sq > eps, torch.sqrt(safe), torch.zeros_like(sq))


def _sin_half_over_angle(angles: torch.Tensor) -> torch.Tensor:
    """sin(angle / 2) / angle, by its Taylor series 1/2 - angle^2 / 48
    below 1e-6."""
    small = angles.abs() < 1e-6
    return torch.where(small, 0.5 - angles * angles / 48.0,
                       torch.sin(angles * 0.5) / torch.where(small, torch.ones_like(angles), angles))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) wxyz, with the small-angle Taylor branch."""
    angles = _safe_norm(axis_angle)
    return torch.cat([torch.cos(angles * 0.5), axis_angle * _sin_half_over_angle(angles)], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    norms = _safe_norm(quaternions[..., 1:])
    angles = 2.0 * torch.atan2(norms, quaternions[..., :1])
    return quaternions[..., 1:] / _sin_half_over_angle(angles)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


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


# --------------------------------------------------------------------------
# 6d representation
# --------------------------------------------------------------------------

def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt (Zhou et al. 2019)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


def rot_mat_to_euler(rot_mats: torch.Tensor) -> torch.Tensor:
    """The y-rotation angle as the FLAME contour-landmark selector reads it
    (reference: utils/lbs.py:26-33)."""
    sy = torch.sqrt(rot_mats[..., 0, 0] * rot_mats[..., 0, 0] + rot_mats[..., 1, 0] * rot_mats[..., 1, 0])
    return torch.atan2(-rot_mats[..., 2, 0], sy)
