"""Step 6: train/val/test splits + (optionally) a seeded toy subset.

Rebuild of reference
dataset_processing/Step6_train_test_validation_split_and_save_pkl.py:
seeded (42) shuffle, 80/10/10 train/valid/test key lists, a 1000-video
toy subset for fast iteration, chunked-pickle save of the selected
subset, and a split-disjointness check (reference: Step6:42-207).
"""

from __future__ import annotations

import argparse
import pickle
import random
from pathlib import Path
from typing import Dict, List, Tuple

from msmd_tpu_torch.data.pickle_dataset import load_chunked_pickle
from msmd_tpu_torch.preprocessing.step5_resample_and_assemble import save_chunked_pickle


def make_splits(keys: List[str], seed: int = 42, train_frac: float = 0.8, valid_frac: float = 0.1) -> Dict[str, List[str]]:
    keys = list(keys)
    random.Random(seed).shuffle(keys)
    n = len(keys)
    n_train = int(train_frac * n)
    n_valid = int(valid_frac * n)
    splits = {
        "train": keys[:n_train],
        "valid": keys[n_train : n_train + n_valid],
        "test": keys[n_train + n_valid :],
    }
    assert_disjoint(splits)
    return splits


def assert_disjoint(splits: Dict[str, List[str]]) -> None:
    """Overlap check (reference: Step6:202-207)."""
    names = list(splits)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            overlap = set(splits[names[i]]) & set(splits[names[j]])
            assert not overlap, f"splits {names[i]}/{names[j]} overlap: {sorted(overlap)[:5]}"


def write_split_files(base_path: Path, name: str, splits: Dict[str, List[str]]) -> None:
    for split, keys in splits.items():
        with open(base_path / f"{name}_keys_{split}.txt", "w") as f:
            f.write("\n".join(keys) + "\n")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--processed_pkl", type=str, required=True, help="Step-5 chunked pickle")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--name", type=str, default="processed_data_30fps_v3")
    parser.add_argument("--toy_size", type=int, default=1000, help="toy subset size (0 disables)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--chunk_size", type=int, default=100)
    args = parser.parse_args()

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    data = load_chunked_pickle(args.processed_pkl)
    keys = sorted(data.keys())
    print(f"{len(keys)} clips")

    # full-set splits
    splits = make_splits(keys, seed=args.seed)
    write_split_files(out, args.name, splits)
    save_chunked_pickle(data, out / f"{args.name}.pkl", args.chunk_size)
    print({k: len(v) for k, v in splits.items()})

    # toy subset (reference: Step6:84-139)
    if args.toy_size > 0 and len(keys) > args.toy_size:
        rng = random.Random(args.seed)
        toy_keys = rng.sample(keys, args.toy_size)
        toy_name = f"{args.name}_toy{args.toy_size}"
        toy_splits = make_splits(toy_keys, seed=args.seed)
        write_split_files(out, toy_name, toy_splits)
        save_chunked_pickle({k: data[k] for k in toy_keys}, out / f"{toy_name}.pkl", args.chunk_size)
        print(f"toy subset: {toy_name}")


if __name__ == "__main__":
    main()
