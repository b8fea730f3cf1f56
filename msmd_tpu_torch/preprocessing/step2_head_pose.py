"""Step 2: per-frame head pose from MediaPipe FaceMesh landmarks.

Rebuild of reference
dataset_processing/Step2_preprocess_head_pose_mediapipe.py: FaceMesh
(478 landmarks) inside 1.2x-scaled bbox crops from Step 1, face
selection by IOU with the tracked bbox, landmark gap interpolation,
Procrustes against the canonical mediapipe face anchors, Savitzky-Golay
quaternion smoothing, the X-180 convention flip, and per-frame
[yaw, pitch, roll] degrees output (YXZ order, roll negated). Sharded,
resumable, JSON run logs.

The canonical-face assets (mediapipe semantic mapping JSON + canonical
face OBJ) ship with mediapipe distributions / the user's asset dir, as
in the reference (Step2:338-339 hardcodes /code paths).
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

from msmd_tpu_torch.preprocessing.headpose import head_pose_track_from_landmarks
from msmd_tpu_torch.preprocessing.runlog import RunLog, load_shard
from msmd_tpu_torch.preprocessing.tracking import calculate_iou, interpolate_gaps


def load_obj_vertices(path) -> np.ndarray:
    """Minimal OBJ vertex loader (reference uses a custom ObjLoader)."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float32)


def static_landmark_indices(mapping: dict) -> list:
    """Procrustes anchors: nose dorsum + lower tip + additional anchors
    (reference: Step2:362)."""
    return mapping["nose"]["dorsum"] + mapping["nose"]["tipLower"] + mapping["additional_anchors"]


def compute_bounding_box(landmarks_xy: np.ndarray, width: int, height: int):
    """(L, 2) normalized landmarks -> pixel (x, y, w, h) (Step2:115-125)."""
    xs = landmarks_xy[:, 0] * width
    ys = landmarks_xy[:, 1] * height
    x_min, x_max = max(int(xs.min()), 0), min(int(xs.max()), width - 1)
    y_min, y_max = max(int(ys.min()), 0), min(int(ys.max()), height - 1)
    return (x_min, y_min, x_max - x_min, y_max - y_min)


def scaled_crop_box(bbox, image_shape, scale: float = 1.2):
    """1.2x-scaled crop window around a tracked bbox (Step2:430-450)."""
    x, y, w, h = bbox
    cx, cy, hw, hh = x + w // 2, y + h // 2, w // 2, h // 2
    hw, hh = int(round(hw * scale)), int(round(hh * scale))
    x_min = max(int(cx) - hw, 0)
    x_max = min(int(cx) + hw, image_shape[1])
    y_min = max(int(cy) - hh, 0)
    y_max = min(int(cy) + hh, image_shape[0])
    return x_min, y_min, x_max, y_max


def extract_video_landmarks(video_path, bbox_list, min_detection_confidence: float = 0.3):
    """Per-frame 478-landmark arrays (None when detection fails), face
    chosen by max IOU with the tracked bbox."""
    import cv2
    import mediapipe as mp

    cap = cv2.VideoCapture(str(video_path))
    raw = []
    with mp.solutions.face_mesh.FaceMesh(
        static_image_mode=False, max_num_faces=10,
        min_detection_confidence=min_detection_confidence, refine_landmarks=True,
    ) as face_mesh:
        counter = 0
        while cap.isOpened():
            ret, image = cap.read()
            if not ret or counter >= len(bbox_list):
                break
            bbox = bbox_list[counter]
            counter += 1
            if isinstance(bbox, list) and not bbox:
                raw.append(None)
                continue
            x_min, y_min, x_max, y_max = scaled_crop_box(bbox, image.shape)
            crop = image[y_min:y_max, x_min:x_max]
            results = face_mesh.process(cv2.cvtColor(crop, cv2.COLOR_BGR2RGB))
            if not results.multi_face_landmarks:
                raw.append(None)
                continue
            h, w = crop.shape[:2]
            best_iou, best = 0.0, None
            for face in results.multi_face_landmarks:
                pts = np.array([[lm.x, lm.y, lm.z] for lm in face.landmark])
                fb = compute_bounding_box(pts[:, :2], w, h)
                fb_orig = (x_min + fb[0], y_min + fb[1], fb[2], fb[3])
                iou = calculate_iou(bbox, fb_orig)
                if iou > best_iou:
                    best_iou, best = iou, pts
            raw.append(best)
    cap.release()
    return raw


def process_video(video_path, bbox_path, output_path, canonical_vertices, static_indices, debug_video_path=None) -> dict:
    with open(bbox_path, "rb") as f:
        bbox_list = pickle.load(f)["processed_bbox_frames"]
    raw = extract_video_landmarks(video_path, bbox_list)
    log = {
        "error_too_many_missing_frames": False,
        "error_missing_landmark_detection": any(x is None for x in raw),
        "error_cant_open_video": len(raw) == 0,
    }
    if log["error_cant_open_video"]:
        return log
    n_missing = sum(x is None for x in raw)
    if n_missing >= len(raw) // 2:
        log["error_too_many_missing_frames"] = True
        return log
    landmarks, _ = interpolate_gaps(raw)
    ypr = head_pose_track_from_landmarks(np.asarray(landmarks), canonical_vertices, static_indices, smooth_window=5, smooth_polyorder=2)
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "wb") as f:
        pickle.dump(ypr, f)
    if debug_video_path is not None:
        # axis-arrow overlay video (reference Step2:570-640)
        from msmd_tpu_torch.preprocessing.debug_video import write_debug_video, ypr_to_rotation_matrices

        Path(debug_video_path).parent.mkdir(parents=True, exist_ok=True)
        log["debug_frames"] = write_debug_video(
            video_path, debug_video_path, ypr_to_rotation_matrices(ypr), bbox_list
        )
    return log


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--shard_id", type=str, required=True)
    parser.add_argument("--video_root", type=str, required=True)
    parser.add_argument("--boundbox_root", type=str, required=True)
    parser.add_argument("--output_root", type=str, required=True)
    parser.add_argument("--shard_root", type=str, required=True)
    parser.add_argument("--log_root", type=str, required=True)
    parser.add_argument("--mapping_path", type=str, required=True, help="mediapipe semantic mapping JSON")
    parser.add_argument("--canonical_face_path", type=str, required=True, help="mediapipe canonical face OBJ")
    parser.add_argument(
        "--debug_video_root", type=str, default=None,
        help="if set, also write per-video axis-arrow debug overlays here (reference Step2:570-640)",
    )
    args = parser.parse_args()

    with open(args.mapping_path) as f:
        mapping = json.load(f)
    static_idx = static_landmark_indices(mapping)
    canonical = load_obj_vertices(args.canonical_face_path)

    names = load_shard(args.shard_root, args.shard_id)
    runlog = RunLog(args.log_root, args.shard_id)
    out_root = Path(args.output_root)
    out_root.mkdir(parents=True, exist_ok=True)

    for name in names:
        out_path = out_root / f"{name}.pkl"
        if runlog.should_skip(name, out_path):
            continue
        entry = {"video_name": name}
        try:
            entry.update(
                process_video(
                    Path(args.video_root) / f"{name}.mp4",
                    Path(args.boundbox_root) / f"{name}.pickle",
                    out_path, canonical, static_idx,
                    debug_video_path=(
                        Path(args.debug_video_root) / f"{name}.mp4" if args.debug_video_root else None
                    ),
                )
            )
        except Exception as e:
            entry["error_unknown"] = repr(e)
        runlog.append(entry)
        print(f"{name}: {entry}")


if __name__ == "__main__":
    main()
