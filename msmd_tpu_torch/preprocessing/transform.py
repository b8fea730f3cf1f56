"""Affine crop utilities for Step 3 (reference:
dataset_processing/transform.py:10-69 — the 200-scale crop convention).
The transform math is pure NumPy; only ``crop_v2``'s warp needs cv2."""

from __future__ import annotations

import numpy as np


def get_dir(src_point, rot_rad: float):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [src_point[0] * cs - src_point[1] * sn, src_point[0] * sn + src_point[1] * cs]


def get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Solve the 2x3 affine mapping src->dst from 3 point pairs (the
    cv2.getAffineTransform computation, NumPy-only)."""
    A = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        A[2 * i, :3] = [src[i, 0], src[i, 1], 1]
        A[2 * i + 1, 3:] = [src[i, 0], src[i, 1], 1]
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    x = np.linalg.solve(A, b)
    return x.reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size, shift=np.array([0, 0], dtype=np.float32), inv=0) -> np.ndarray:
    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale])
    scale_tmp = np.asarray(scale) * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * np.asarray(shift)
    src[1, :] = center + src_dir + scale_tmp * np.asarray(shift)
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _affine_from_points(dst, src)
    return _affine_from_points(src, dst)


def crop_v2(img: np.ndarray, center, scale, output_size, rot: float = 0):
    """Warp-crop an image with the 200-scale convention. Needs cv2."""
    import cv2

    trans = get_affine_transform(center, scale, rot, output_size)
    dst = cv2.warpAffine(img, trans, (int(output_size[0]), int(output_size[1])), flags=cv2.INTER_LINEAR)
    return dst, trans


def transform_pixel_v2(pt: np.ndarray, trans: np.ndarray, inverse: bool = False) -> np.ndarray:
    if not inverse:
        return pt @ trans[:, 0:2].T + trans[:, 2]
    return (pt - trans[:, 2]) @ np.linalg.inv(trans[:, 0:2].T)
