"""Step 1: per-frame face detection + single-track bbox selection.

Rebuild of reference
dataset_processing/Step1_preprocess_boundbox_mediapipe.py: MediaPipe
FaceDetection over every frame, IOU-based single-track selection over a
K=5 window (msmd_tpu.preprocessing.tracking), gap interpolation, and a
per-video pickle ``{raw_bbox_frames, processed_bbox_frames, flags, fps,
dims}``. Sharded via ``video_split_<shard>.pkl``; resumable; JSON run
logs.

Usage:
  python -m msmd_tpu_torch.preprocessing.step1_detect_faces \
      --shard_id 0 --video_root ... --output_root ... --shard_root ... \
      --log_root ...
"""

from __future__ import annotations

import argparse
import pickle
import time
from pathlib import Path

import numpy as np

from msmd_tpu_torch.preprocessing.runlog import RunLog, load_shard
from msmd_tpu_torch.preprocessing.tracking import filter_boxes


def detect_video_boxes(video_path, min_detection_confidence: float = 0.5):
    """Run MediaPipe FaceDetection on every frame. Returns
    (per-frame [(score, (x, y, w, h)), ...], fps, (width, height))."""
    import cv2
    import mediapipe as mp

    cap = cv2.VideoCapture(str(video_path))
    fps = cap.get(cv2.CAP_PROP_FPS)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    all_frames = []
    with mp.solutions.face_detection.FaceDetection(
        model_selection=1, min_detection_confidence=min_detection_confidence
    ) as detector:
        while cap.isOpened():
            ret, frame = cap.read()
            if not ret:
                break
            results = detector.process(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            frame_boxes = []
            if results.detections:
                for det in results.detections:
                    box = det.location_data.relative_bounding_box
                    frame_boxes.append(
                        (
                            det.score[0],
                            (
                                box.xmin * width,
                                box.ymin * height,
                                box.width * width,
                                box.height * height,
                            ),
                        )
                    )
            all_frames.append(frame_boxes)
    cap.release()
    return all_frames, fps, (width, height)


def process_video(video_path, output_path, K: int = 5) -> dict:
    raw_boxes, fps, dims = detect_video_boxes(video_path)
    processed, flags = filter_boxes(raw_boxes, K=K)
    payload = {
        "raw_bbox_frames": raw_boxes,
        "processed_bbox_frames": [np.asarray(b, float).round().astype(int).tolist() if not (isinstance(b, list) and not b) else [] for b in processed],
        "flags": flags,
        "fps": fps,
        "dims": dims,
    }
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "wb") as f:
        pickle.dump(payload, f)
    return flags


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--shard_id", type=str, required=True)
    parser.add_argument("--video_root", type=str, required=True)
    parser.add_argument("--output_root", type=str, required=True)
    parser.add_argument("--shard_root", type=str, required=True)
    parser.add_argument("--log_root", type=str, required=True)
    parser.add_argument("--K", type=int, default=5, help="IOU tracking window")
    args = parser.parse_args()

    names = load_shard(args.shard_root, args.shard_id)
    runlog = RunLog(args.log_root, args.shard_id)
    out_root = Path(args.output_root)
    out_root.mkdir(parents=True, exist_ok=True)

    for name in names:
        out_path = out_root / f"{name}.pickle"
        if runlog.should_skip(name, out_path):
            print(f"skip {name} (exists)")
            continue
        entry = {"video_name": name, "error": None, "flags": None, "wall_s": None}
        t0 = time.time()
        try:
            flags = process_video(Path(args.video_root) / f"{name}.mp4", out_path, K=args.K)
            entry["flags"] = flags
        except Exception as e:  # per-video isolation, like the reference
            entry["error"] = repr(e)
        entry["wall_s"] = time.time() - t0
        runlog.append(entry)
        print(f"{name}: {entry}")


if __name__ == "__main__":
    main()
