"""Synthetic dataset generator (the port's own copy of
``msmd_tpu/data/synthetic.py``) emitting the exact Step-6 on-disk format
(reference: dataset_processing/Step6_...py:7-20 chunked-pickle save;
entry schema {key: {audio, expression_code (T, 64), head_orientation
(T, 3)}} per datasets.py:264-266).

Used by tests and benchmarks so the full data pipeline can run without
the licensed RAVDESS/CelebV-Text data.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def write_synthetic_dataset(
    out_dir,
    name: str = "processed_data_30fps_medium_v3",
    n_videos: int = 12,
    fps: int = 30,
    min_seconds: float = 2.0,
    max_seconds: float = 12.0,
    exp_dim: int = 64,
    chunk_size: int = 4,
    seed: int = 0,
    audio_sr: int = 16000,
):
    """Writes ``{name}.pkl`` (chunked) + ``{name}_keys_{train,valid,test}.txt``
    split files (80/10/10, matching Step 6's ratios). Returns the pkl path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)

    data = {}
    for i in range(n_videos):
        secs = rng.uniform(min_seconds, max_seconds)
        n_frames = int(secs * fps)
        key = f"synthetic_{i:04d}"
        # smooth random motion so velocity/smoothness losses are meaningful
        t = np.linspace(0, secs, n_frames)[:, None]
        freqs = rng.uniform(0.3, 2.0, (1, exp_dim))
        phases = rng.uniform(0, 2 * np.pi, (1, exp_dim))
        data[key] = {
            "expression_code": (np.sin(2 * np.pi * freqs * t + phases) * rng.uniform(0.1, 1.0, (1, exp_dim))).astype(np.float32),
            "head_orientation": (np.sin(2 * np.pi * rng.uniform(0.1, 0.5, (1, 3)) * t) * 15.0).astype(np.float32),
            "audio": rng.randn(int(secs * audio_sr)).astype(np.float32) * 0.1,
        }

    pkl_path = out_dir / f"{name}.pkl"
    keys = list(data.keys())
    with open(pkl_path, "wb") as f:
        for s in range(0, len(keys), chunk_size):
            pickle.dump({k: data[k] for k in keys[s : s + chunk_size]}, f)

    rng.shuffle(keys)
    n_train = max(1, int(0.8 * len(keys)))
    n_val = max(1, int(0.1 * len(keys)))
    splits = {
        "train": keys[:n_train],
        "valid": keys[n_train : n_train + n_val],
        "test": keys[n_train + n_val :] or keys[-1:],
    }
    for split, ks in splits.items():
        with open(out_dir / f"{name}_keys_{split}.txt", "w") as f:
            f.write("\n".join(ks) + "\n")
    return pkl_path
