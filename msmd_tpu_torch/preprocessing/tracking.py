"""Single-face bbox track selection over per-frame multi-detections.

Pure-NumPy core of Step 1 (reference:
dataset_processing/Step1_preprocess_boundbox_mediapipe.py:10-160):
IOU-based selection against the previous K frames, look-ahead
disambiguation when the first frame has multiple faces, gap
interpolation, and quality flags.

Boxes are (x, y, w, h)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def calculate_iou(box1: Sequence[float], box2: Sequence[float]) -> float:
    """IoU of two (x, y, w, h) boxes (reference: Step1:10-28)."""
    x1, y1, w1, h1 = box1
    x2, y2, w2, h2 = box2
    xa, ya = max(x1, x2), max(y1, y2)
    xb, yb = min(x1 + w1, x2 + w2), min(y1 + h1, y2 + h2)
    inter = max(0.0, xb - xa) * max(0.0, yb - ya)
    union = w1 * h1 + w2 * h2 - inter
    return inter / union if union > 0 else 0.0


def _lerp_boxes(left_idx: int, right_idx: int, left_box, right_box, i: int) -> np.ndarray:
    t = (i - left_idx) / (right_idx - left_idx)
    return (1 - t) * np.asarray(left_box, float) + t * np.asarray(right_box, float)


def filter_boxes(all_frames_boxes: List[List], K: int = 5, iou_threshold: float = 0.4) -> Tuple[List, Dict[str, bool]]:
    """Select one box per frame from per-frame candidate lists.

    ``all_frames_boxes[i]`` is a list of (score, (x, y, w, h)) candidates
    (empty when no detection). Returns (per-frame boxes with gaps
    linearly interpolated, quality flags) — semantics of reference
    Step1:30-120:

    - single candidate: take it
    - multiple candidates on the FIRST non-empty frame: pick the one
      with the highest summed IOU against the next up-to-3 single-box
      frames within a K-frame lookahead
    - multiple candidates later: pick the best mean IOU against the
      selected boxes of the previous K frames; if the best IOU is
      below ``iou_threshold``, repeat the previous frame's box
    - empty frames: flagged and filled by linear interpolation
      (endpoints copied from the nearest detection)
    """
    flags = {
        "has_missing": False,
        "has_multiple": False,
        "no_first_frame": False,
        "no_last_frame": False,
        "multiple_boxes_first_frame": False,
    }
    non_empty = [fb for fb in all_frames_boxes if fb]
    empty_positions = [i for i, fb in enumerate(all_frames_boxes) if not fb]
    if empty_positions:
        flags["has_missing"] = True
    if not non_empty:
        return [[] for _ in all_frames_boxes], flags

    selected: List = []
    for i, frame_boxes in enumerate(non_empty):
        if i == 0 and len(frame_boxes) > 1:
            flags["multiple_boxes_first_frame"] = True
            flags["has_multiple"] = True
            # look ahead for up to 3 single-box frames within K
            singles = []
            for j in range(i + 1, min(i + K + 1, len(non_empty))):
                if len(non_empty[j]) == 1:
                    singles.append(j)
                if len(singles) == 3:
                    break
            ious = np.zeros(len(frame_boxes))
            for j in singles:
                ious += np.array([calculate_iou(fb[1], non_empty[j][0][1]) for fb in frame_boxes])
            selected.append(np.asarray(frame_boxes[int(np.argmax(ious))][1], float))
        elif len(frame_boxes) == 1:
            selected.append(np.asarray(frame_boxes[0][1], float))
        else:
            flags["has_multiple"] = True
            ious = np.zeros(len(frame_boxes))
            for j in range(max(0, i - K), i):
                ious += np.array([calculate_iou(fb[1], selected[j]) for fb in frame_boxes])
            ious /= K
            if ious.max() > iou_threshold:
                selected.append(np.asarray(frame_boxes[int(np.argmax(ious))][1], float))
            else:
                selected.append(selected[-1])

    # re-insert empty frames at their original positions
    result: List = list(selected)
    for i in sorted(empty_positions):
        result.insert(i, [])

    # endpoints: copy nearest detection inward (reference Step1:90-104)
    if isinstance(result[0], list) and not result[0]:
        flags["no_first_frame"] = True
        for i in range(1, len(result)):
            if not (isinstance(result[i], list) and not result[i]):
                result[0] = result[i]
                break
    if isinstance(result[-1], list) and not result[-1]:
        flags["no_last_frame"] = True
        for i in range(len(result) - 2, -1, -1):
            if not (isinstance(result[i], list) and not result[i]):
                result[-1] = result[i]
                break

    # linear interpolation over interior gaps (reference Step1:105-120)
    for i in range(len(result)):
        if isinstance(result[i], list) and not result[i]:
            left = i
            while left > 0 and isinstance(result[left], list) and not result[left]:
                left -= 1
            right = i
            while right < len(result) - 1 and isinstance(result[right], list) and not result[right]:
                right += 1
            lb, rb = result[left], result[right]
            if (isinstance(lb, list) and not lb) or (isinstance(rb, list) and not rb):
                continue
            result[i] = _lerp_boxes(left, right, lb, rb, i)
    return result, flags


def interpolate_gaps(arrays: List[Optional[np.ndarray]]) -> Tuple[List[np.ndarray], Dict[str, int]]:
    """Fill None entries in a per-frame array sequence by linear
    interpolation between the nearest valid neighbors; endpoints copy the
    nearest valid frame (reference Step2 interpolate_landmarks:265-295
    semantics, minus the broken Rotation.slerp path noted in SURVEY.md)."""
    n = len(arrays)
    valid = [i for i, a in enumerate(arrays) if a is not None]
    log = {"n_missing": n - len(valid)}
    if not valid:
        raise ValueError("No valid frames to interpolate from")
    out: List[Optional[np.ndarray]] = list(arrays)
    first, last = valid[0], valid[-1]
    for i in range(first):
        out[i] = np.array(arrays[first])
    for i in range(last + 1, n):
        out[i] = np.array(arrays[last])
    for a, b in zip(valid[:-1], valid[1:]):
        for i in range(a + 1, b):
            t = (i - a) / (b - a)
            out[i] = (1 - t) * arrays[a] + t * arrays[b]
    return out, log
