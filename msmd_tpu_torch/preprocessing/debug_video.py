"""Step-2 debug-video rendering: head-pose axis arrows + angle text
overlaid on the source video (reference:
dataset_processing/Step2_preprocess_head_pose_mediapipe.py:570-640).

The projection math (`project_pose_axes`) is a pure function so it is
unit-testable without OpenCV; the drawing/IO wrappers require cv2 and
are import-gated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def ypr_to_rotation_matrices(ypr_deg: np.ndarray) -> np.ndarray:
    """[yaw, pitch, roll] degrees (Step-2 output convention) -> (T, 3, 3)
    rotation matrices, reproducing the reference's R_modified
    reconstruction (Step2:555-568: YXZ euler with the roll sign flip
    undone)."""
    from scipy.spatial.transform import Rotation

    ypr = np.asarray(ypr_deg, np.float64).reshape(-1, 3)
    eul = ypr.copy()
    eul[:, 2] = -eul[:, 2]  # the stored roll is negated; undo for the matrix
    return Rotation.from_euler("YXZ", eul, degrees=True).as_matrix()


def project_pose_axes(R: np.ndarray, bbox: Sequence[float], axis_length: float = 200.0) -> np.ndarray:
    """Orthographic projection of the head-pose axes onto the frame
    (reference Step2:585-625): rotate the 3D axis endpoints by R, drop
    Z, and shift to the bounding-box center. Returns (4, 2) int pixel
    coords: [origin, x_end, y_end, z_end]."""
    x, y, w, h = bbox
    center = np.array([x + w // 2, y + h // 2], np.float64)
    axes_3d = np.float64(
        [[0, 0, 0], [axis_length, 0, 0], [0, axis_length, 0], [0, 0, axis_length]]
    )
    rotated = np.asarray(R, np.float64) @ axes_3d.T  # (3, 4)
    projected = rotated[:2, :].T + center  # orthographic: ignore Z
    return projected.astype(int)


def overlay_pose_debug(frame, R: np.ndarray, bbox: Sequence[float], axis_length: float = 200.0):
    """Draw the X (red) / Y (green) / Z (blue) arrows and the YPR text on
    one BGR frame in place (reference Step2:627-640)."""
    import cv2 as cv
    from scipy.spatial.transform import Rotation

    pts = project_pose_axes(R, bbox, axis_length)
    origin = tuple(pts[0])
    cv.arrowedLine(frame, origin, tuple(pts[1]), (0, 0, 255), 2, tipLength=0.2)
    cv.arrowedLine(frame, origin, tuple(pts[2]), (0, 255, 0), 2, tipLength=0.2)
    cv.arrowedLine(frame, origin, tuple(pts[3]), (255, 0, 0), 2, tipLength=0.2)

    yaw, pitch, roll = Rotation.from_matrix(np.asarray(R, np.float64)).as_euler("YXZ", degrees=True)
    text = f"Yaw: {yaw:.2f}, Pitch: {pitch:.2f}, Roll: {roll:.2f}"
    x, y = int(round(bbox[0])), int(round(bbox[1]))
    cv.putText(frame, text, (x, y - 10), cv.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2)
    return frame


def write_debug_video(
    video_path,
    out_path,
    rotation_matrices: Sequence[Optional[np.ndarray]],
    bbox_list: Sequence[Sequence[float]],
    axis_length: float = 200.0,
) -> int:
    """Re-encode the source video with pose-axis overlays; returns the
    number of frames written (reference Step2:574-645)."""
    import cv2 as cv

    cap = cv.VideoCapture(str(video_path))
    fourcc = cv.VideoWriter_fourcc(*"mp4v")
    fps = cap.get(cv.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv.CAP_PROP_FRAME_HEIGHT))
    out = cv.VideoWriter(str(out_path), fourcc, fps, (w, h))

    n = 0
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret or n >= len(rotation_matrices) or n >= len(bbox_list):
            break
        R = rotation_matrices[n]
        bbox = bbox_list[n]
        # Step-1 stores [] for frames without a detection
        # (step1_detect_faces) — pass those through without an overlay
        if R is not None and bbox is not None and len(bbox) == 4:
            overlay_pose_debug(frame, R, bbox, axis_length)
        out.write(frame)
        n += 1
    cap.release()
    out.release()
    return n
