"""Head-pose numerics for Step 2 (the port of
``msmd_tpu/preprocessing/headpose.py``; NumPy / SciPy, the quaternion
conversions on the port's rotations).

Core math of reference
dataset_processing/Step2_preprocess_head_pose_mediapipe.py:15-111:
Procrustes alignment of per-frame landmarks against a canonical
mediapipe face (nose dorsum/tip + anchor points), Savitzky-Golay
quaternion smoothing of the rotation track, the X-180-degree convention
flip, and the final [yaw, pitch, roll] (YXZ, degrees, roll negated)
output.

The JAX package runs the quaternion conversions through ``jnp.asarray``
without x64, that is in float32 on float64 input; the port casts to
float32 at the same places, so both give the same track at f32
tolerance."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def procrustes_analysis(X: np.ndarray, Y: np.ndarray):
    """Best-fit similarity transform Y ~ c R X + t for (3, N) point sets
    (reference: Step2:68-92, Umeyama with rank-aware sign fix).
    Returns (R (3,3), c scalar, t (3,1))."""
    mu_x = X.mean(axis=1)
    mu_y = Y.mean(axis=1)
    rho2_x = X.var(axis=1).sum()
    cov_xy = (1.0 / X.shape[1]) * (Y - mu_y[:, None]) @ (X - mu_x[:, None]).T
    U, D, V_T = np.linalg.svd(cov_xy)
    S = np.identity(3)
    if np.linalg.matrix_rank(cov_xy) >= X.shape[0] - 1:
        if np.linalg.det(cov_xy) < 0:
            S[-1, -1] = -1
    else:
        if np.linalg.det(U) * np.linalg.det(V_T) < 0:
            S[-1, -1] = -1
    R = U @ S @ V_T
    c = (1.0 / rho2_x) * np.sum(D * np.diag(S))
    t = mu_y - c * R @ mu_x
    return R, c, t[:, None]


def rotate_to_neutral(neutral_pose: np.ndarray, data: np.ndarray, static_indices: Sequence[int], return_rotation: bool = False):
    """Align every frame of (T, L, 3) landmarks to the canonical face
    using only the static anchor landmarks (reference: Step2:94-111)."""
    out = np.zeros(data.shape)
    rotations, translations = [], []
    for i in range(data.shape[0]):
        R, c, t = procrustes_analysis(data[i, static_indices].T, neutral_pose[static_indices].T)
        rotations.append(R)
        translations.append(t)
        out[i] = (c * R @ data[i].T + t).T
    if return_rotation:
        return out, rotations, translations
    return out


def _f32(a: np.ndarray) -> torch.Tensor:
    """float32, where the JAX package's ``jnp.asarray`` (no x64) casts."""
    return torch.as_tensor(np.asarray(a, np.float32))


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    from msmd_tpu_torch.ops.rotations import matrix_to_quaternion  # wxyz

    q = matrix_to_quaternion(_f32(R[None]))[0].numpy()
    # scipy-style xyzw for internal consistency below
    return np.array([q[1], q[2], q[3], q[0]])


def _quat_to_mat(q_xyzw: np.ndarray) -> np.ndarray:
    from msmd_tpu_torch.ops.rotations import quaternion_to_matrix

    q = np.array([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]])
    return quaternion_to_matrix(_f32(q[None]))[0].numpy()


def smooth_rotation_matrices(rotation_matrices: Sequence[np.ndarray], window_length: int = 7, polyorder: int = 3) -> List[np.ndarray]:
    """Savitzky-Golay smoothing of a rotation track via sign-consistent
    quaternions (reference: Step2:15-52)."""
    from scipy.signal import savgol_filter

    quats = np.array([_mat_to_quat(np.asarray(R)) for R in rotation_matrices])
    for i in range(1, len(quats)):
        if np.dot(quats[i], quats[i - 1]) < 0:
            quats[i] = -quats[i]
    smoothed = np.zeros_like(quats)
    wl = min(window_length, len(quats) if len(quats) % 2 == 1 else len(quats) - 1)
    wl = max(wl, polyorder + 1 + (polyorder % 2 == 0))
    for i in range(4):
        smoothed[:, i] = savgol_filter(quats[:, i], window_length=wl, polyorder=min(polyorder, wl - 1), mode="interp")
    smoothed /= np.linalg.norm(smoothed, axis=1, keepdims=True)
    return [_quat_to_mat(q) for q in smoothed]


def rotations_to_yaw_pitch_roll(rotation_matrices: Sequence[np.ndarray]) -> np.ndarray:
    """Convention of the reference output (Step2:546-568): flip by 180
    degrees around X so forward = (0,0,0), then YXZ euler in degrees with
    roll negated. Returns (T, 3) [yaw, pitch, roll]."""
    from msmd_tpu_torch.ops.rotations import matrix_to_euler_angles

    r_adjust = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], float)  # Rx(180 deg)
    out = []
    for R in rotation_matrices:
        R_adj = r_adjust @ np.asarray(R)
        # scipy's extrinsic 'YXZ' == PyTorch3D-intrinsic 'YXZ' transpose
        # relationship; use scipy when available for exactness
        try:
            from scipy.spatial.transform import Rotation

            yaw, pitch, roll = Rotation.from_matrix(R_adj).as_euler("YXZ", degrees=True)
        except ImportError:
            e = matrix_to_euler_angles(_f32(R_adj[None]), "YXZ")[0].numpy() * 180.0 / np.pi
            yaw, pitch, roll = e
        out.append([yaw, pitch, -roll])
    return np.asarray(out)


def side_profile_fraction(yaw_deg: np.ndarray, threshold: float = 50.0) -> float:
    """Fraction of frames with |yaw| above threshold (reference Step4's
    side-profile filter, Step4:219-242)."""
    return float((np.abs(yaw_deg) > threshold).mean())


def head_pose_track_from_landmarks(
    landmarks: np.ndarray,
    canonical_vertices: np.ndarray,
    static_indices: Sequence[int],
    smooth_window: int = 5,
    smooth_polyorder: int = 2,
) -> np.ndarray:
    """Full Step-2 numeric path: (T, 478, 3) landmarks -> (T, 3)
    [yaw, pitch, roll] degrees."""
    _, rotations, _ = rotate_to_neutral(canonical_vertices, landmarks, static_indices, return_rotation=True)
    rotations = smooth_rotation_matrices(rotations, smooth_window, smooth_polyorder)
    return rotations_to_yaw_pitch_roll(rotations)
