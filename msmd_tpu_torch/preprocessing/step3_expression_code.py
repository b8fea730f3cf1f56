"""Step 3: per-frame expression-code extraction (user-model extension
point).

Rebuild of reference
dataset_processing/Step3_preprocess_expression_code.py: Savitzky-Golay
smoothing of the tracked bboxes, affine crop to 256x256 (the 200-scale
convention of transform.py), ImageNet normalization, batched inference
through a facial-reconstruction network, and optional smoothing of the
output codes.

``ExpressionCodeExtractor`` is a documented placeholder exactly as in
the reference (Step3:22-32; README.MD:40-42 — "you NEED a facial
reconstruction model... replace the placeholder class"). Plug in FLAME
or SEREP by subclassing and implementing ``__call__``. This rebuild also
declares the full argparse surface the reference consumed but never
declared (SURVEY.md: Step3:125,151,155,213,237).
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import List, Optional

import numpy as np

from msmd_tpu_torch.preprocessing.runlog import RunLog, load_shard
from msmd_tpu_torch.preprocessing.transform import crop_v2

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ExpressionCodeExtractor:
    """PLACEHOLDER — replace with your facial reconstruction model
    (FLAME / SEREP). ``__call__`` takes a (B, 3, 256, 256) float batch
    (ImageNet-normalized RGB) and must return
    (landmarks (B, L, 2), expression_code (B, D))."""

    def __init__(self, code_dim: int = 64):
        self.code_dim = code_dim

    def __call__(self, batch: np.ndarray):
        raise NotImplementedError(
            "Provide a facial reconstruction model: subclass "
            "ExpressionCodeExtractor and implement __call__ "
            "(see README / reference Step3)."
        )


def smooth_boxes(boxes: np.ndarray, window_length: int = 9, polyorder: int = 2) -> np.ndarray:
    """Savitzky-Golay smoothing of the (T, 4) bbox track (Step3:35-46)."""
    from scipy.signal import savgol_filter

    boxes = np.asarray(boxes, float)
    wl = min(window_length, len(boxes) if len(boxes) % 2 == 1 else len(boxes) - 1)
    if wl <= polyorder:
        return boxes
    out = np.stack([savgol_filter(boxes[:, i], wl, polyorder, mode="interp") for i in range(4)], axis=1)
    return out


def crop_and_normalize(image: np.ndarray, bbox, output_size: int = 256, scale_mult: float = 1.25):
    """Affine-crop a face bbox to (3, S, S) ImageNet-normalized float
    (Step3:35-61 crop + :88-99 batch prep)."""
    x, y, w, h = bbox
    center = np.array([x + w / 2, y + h / 2], np.float32)
    scale = max(w, h) * scale_mult / 200.0
    crop, trans = crop_v2(image, center, scale, (output_size, output_size))
    rgb = crop[..., ::-1].astype(np.float32) / 255.0  # BGR -> RGB
    rgb = (rgb - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(rgb, (2, 0, 1)), trans


def extract_codes_for_video(video_path, bbox_path, extractor: ExpressionCodeExtractor, batch_size: int = 32, smooth_bbox: bool = True, smoothing_type: Optional[str] = "savgol", smooth_window: int = 9):
    """Run the extractor over every frame; returns
    (landmarks (T, L, 2), codes (T, D))."""
    import cv2

    with open(bbox_path, "rb") as f:
        boxes = pickle.load(f)["processed_bbox_frames"]
    boxes = np.asarray([b if not (isinstance(b, list) and not b) else [0, 0, 1, 1] for b in boxes], float)
    if smooth_bbox:
        boxes = smooth_boxes(boxes, window_length=smooth_window)

    cap = cv2.VideoCapture(str(video_path))
    frames: List[np.ndarray] = []
    idx = 0
    while cap.isOpened() and idx < len(boxes):
        ret, image = cap.read()
        if not ret:
            break
        crop, _ = crop_and_normalize(image, boxes[idx])
        frames.append(crop)
        idx += 1
    cap.release()

    landmarks, codes = [], []
    for s in range(0, len(frames), batch_size):
        lm, code = extractor(np.stack(frames[s : s + batch_size]))
        landmarks.append(np.asarray(lm))
        codes.append(np.asarray(code))
    landmarks = np.concatenate(landmarks) if landmarks else np.zeros((0, 0, 2))
    codes = np.concatenate(codes) if codes else np.zeros((0, extractor.code_dim))

    if smoothing_type == "savgol" and len(codes) > 5:
        from scipy.signal import savgol_filter

        wl = 5
        codes = np.stack([savgol_filter(codes[:, i], wl, 2, mode="interp") for i in range(codes.shape[1])], axis=1)
    return landmarks, codes


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--shard_id", type=str, required=True)
    parser.add_argument("--video_root", type=str, required=True)
    parser.add_argument("--boundbox_root", type=str, required=True)
    parser.add_argument("--output_root", type=str, required=True)
    parser.add_argument("--shard_root", type=str, required=True)
    parser.add_argument("--log_root", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=32)
    # flags the reference consumed but never declared:
    parser.add_argument("--smoothing_type", type=str, default="savgol", choices=["savgol", "none"])
    parser.add_argument("--smooth_window", type=int, default=9)
    parser.add_argument("--no_smooth_bbox", action="store_true")
    args = parser.parse_args()

    extractor = ExpressionCodeExtractor()  # user must replace
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
            lm, codes = extract_codes_for_video(
                Path(args.video_root) / f"{name}.mp4",
                Path(args.boundbox_root) / f"{name}.pickle",
                extractor,
                batch_size=args.batch_size,
                smooth_bbox=not args.no_smooth_bbox,
                smoothing_type=args.smoothing_type,
                smooth_window=args.smooth_window,
            )
            with open(out_path, "wb") as f:
                pickle.dump(codes, f)
            entry["n_frames"] = int(codes.shape[0])
        except NotImplementedError as e:
            raise SystemExit(str(e))
        except Exception as e:
            entry["error"] = repr(e)
        runlog.append(entry)


if __name__ == "__main__":
    main()
