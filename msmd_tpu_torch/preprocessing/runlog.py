"""Resumable-run infrastructure shared by all preprocessing steps
(reference pattern: Step1:236-275, Step2:378-399, Step5:82-93 — skip
existing outputs, persist JSON run logs, shard by video_split_*.pkl)."""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import List, Optional


def load_shard(shard_root, shard_id: str) -> List[str]:
    """Read video_split_<shard>.pkl: a list of video names (possibly
    wrapped in 1-element lists, a reference legacy quirk — Step2:380)."""
    with open(Path(shard_root) / f"video_split_{shard_id}.pkl", "rb") as f:
        names = pickle.load(f)
    return [n[0] if isinstance(n, (list, tuple)) else n for n in names]


class RunLog:
    """Append-only JSON run log with resume support."""

    def __init__(self, log_root, shard_id: str):
        self.path = Path(log_root) / f"runlog_{shard_id}.json"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.entries: List[dict] = []
        if self.path.exists():
            with open(self.path) as f:
                self._previous = {e["video_name"]: e for e in json.load(f)}
        else:
            self._previous = {}

    def previous_entry(self, video_name: str) -> Optional[dict]:
        return self._previous.get(video_name)

    def append(self, entry: dict) -> None:
        self.entries.append(entry)
        with open(self.path, "w") as f:
            json.dump(self.entries, f)

    def should_skip(self, video_name: str, output_path) -> bool:
        """Skip when the output exists AND a previous log entry is found
        (reference: Step2:378-399); carries the old entry forward."""
        if Path(output_path).exists():
            prev = self.previous_entry(video_name)
            if prev is not None:
                self.append(prev)
                return True
        return False
