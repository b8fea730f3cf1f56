"""Step 4: dataset filtering -> keys.txt.

Rebuild of reference dataset_processing/Step4_filter_dataset.py:36-248.
Keeps videos that (1) have an audio file, (2) carry a speech-like action
annotation {sing, shout, whisper, talk, read}, (3) have valid
head-tracking output (Step 2 produced a pose pkl and didn't flag
too-many-missing-frames), and (4) are less than 50% side-profile
(|yaw| > 50 degrees). Writes the surviving video ids to keys.txt.

Filters are small pure functions so they're unit-testable without the
dataset on disk.
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path
from typing import Dict, Iterable, List, Set

import numpy as np

TALKING_LABELS = ("sing", "shout", "whisper", "talk", "read")
SIDE_YAW_THRESHOLD = 50.0
SIDE_FRACTION = 0.5


def filter_has_audio(video_ids: Iterable[str], audio_ids: Set[str]) -> List[str]:
    return [v for v in video_ids if v in audio_ids]


def filter_speech_annotations(video_ids: Iterable[str], action_annotations: Dict[str, list]) -> List[str]:
    """Keep videos whose action list contains a speech-ish label
    (reference: Step4:98-152; videos missing annotations are dropped)."""
    kept = []
    for vid in video_ids:
        acts = action_annotations.get(vid)
        if acts is None:
            continue
        labels = [a[0] for a in acts]
        if any(lbl in TALKING_LABELS for lbl in labels):
            kept.append(vid)
    return kept


def filter_valid_tracking(video_ids: Iterable[str], head_orientation_root, runlogs: Iterable[dict] = ()) -> List[str]:
    """Keep videos with a head-pose pkl on disk, minus those any runlog
    flagged as too-many-missing-frames (reference: Step4:156-216)."""
    root = Path(head_orientation_root)
    bad = {e["video_name"] for e in runlogs if e.get("error_too_many_missing_frames")}
    return [v for v in video_ids if (root / f"{v}.pkl").exists() and v not in bad]


def filter_side_profiles(video_ids: Iterable[str], head_orientation_root, threshold: float = SIDE_YAW_THRESHOLD, frac: float = SIDE_FRACTION) -> List[str]:
    """Drop videos where more than ``frac`` of frames have |yaw| above
    ``threshold`` (reference: Step4:219-242)."""
    kept = []
    for vid in video_ids:
        with open(Path(head_orientation_root) / f"{vid}.pkl", "rb") as f:
            pose = np.asarray(pickle.load(f))
        side = np.abs(pose[:, 0]) > threshold
        if side.sum() <= frac * len(side):
            kept.append(vid)
    return kept


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_root", type=str, required=True)
    parser.add_argument("--video_dir", type=str, default="videos")
    parser.add_argument("--audio_dir", type=str, default="audios")
    parser.add_argument("--head_orientation_dir", type=str, default="head_orientations")
    parser.add_argument("--annotation_file", type=str, default="annotations.pkl")
    parser.add_argument("--output", type=str, default="keys.txt")
    args = parser.parse_args()

    root = Path(args.dataset_root)
    video_ids = sorted(p.stem for p in (root / args.video_dir).glob("*.mp4"))
    audio_ids = {p.stem for p in (root / args.audio_dir).iterdir() if p.suffix in (".m4a", ".wav", ".mp3")}

    usable = filter_has_audio(video_ids, audio_ids)
    print(f"with audio: {len(usable)} / {len(video_ids)}")

    ann_path = root / args.annotation_file
    if ann_path.exists():
        with open(ann_path, "rb") as f:
            annotations = pickle.load(f)
        usable = filter_speech_annotations(usable, annotations.get("act", {}))
        print(f"with speech annotations: {len(usable)}")

    ho_root = root / args.head_orientation_dir
    runlogs = []
    for log_file in (ho_root / "runlog").glob("runlog_*.json"):
        with open(log_file) as f:
            runlogs.extend(json.load(f))
    usable = filter_valid_tracking(usable, ho_root, runlogs)
    print(f"with valid tracking: {len(usable)}")

    usable = filter_side_profiles(usable, ho_root)
    print(f"mostly forward-facing: {len(usable)}")

    with open(root / args.output, "w") as f:
        f.write("\n".join(usable) + "\n")
    print(f"wrote {len(usable)} keys to {root / args.output}")


if __name__ == "__main__":
    main()
