"""Step 5: resample + assemble the processed dataset store.

Rebuild of reference
dataset_processing/Step5_resample_and_assemble.py:40-167: per surviving
video, Fourier-resample (scipy.signal.resample) head pose + expression
code to the goal fps and audio to 16 kHz, then write BOTH an LMDB store
and a chunked pickle of ``{head_orientation, expression_code, audio}``.
Resumable (already-present LMDB keys are skipped) with persisted
error-file tracking.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def resample_clip(head_orientation: np.ndarray, expression_code: np.ndarray, audio: np.ndarray, video_fps: float, audio_sr: float, goal_fps: int = 30, goal_sr: int = 16000) -> Dict[str, np.ndarray]:
    """Fourier resampling of all three tracks (reference: Step5:144-147)."""
    from scipy import signal

    if audio.ndim > 1:
        audio = audio[:, 0]
    return {
        "head_orientation": signal.resample(head_orientation, int(len(head_orientation) * goal_fps / video_fps)),
        "expression_code": signal.resample(expression_code, int(len(expression_code) * goal_fps / video_fps)),
        "audio": signal.resample(audio, int(len(audio) * goal_sr / audio_sr)),
    }


def save_chunked_pickle(data: Dict[str, dict], path, chunk_size: int = 100) -> None:
    """Chunked-pickle writer (reference: Step6:7-20 save_dict_in_chunks)."""
    keys = list(data.keys())
    with open(path, "wb") as f:
        for s in range(0, len(keys), chunk_size):
            pickle.dump({k: data[k] for k in keys[s : s + chunk_size]}, f)


def load_audio_any(path, sr: Optional[int] = None):
    """(audio, sr) via librosa else soundfile (reference uses librosa)."""
    try:
        import librosa

        y, s = librosa.load(path, sr=sr)
        return y, s
    except ImportError:
        import soundfile as sf

        y, s = sf.read(path, dtype="float32")
        return y, s


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_root", type=str, required=True)
    parser.add_argument("--goal_fps", type=int, default=30)
    parser.add_argument("--goal_sr", type=int, default=16000)
    parser.add_argument("--head_orientation_dir", type=str, default="head_orientations")
    parser.add_argument("--expression_code_dir", type=str, default="expression_code")
    parser.add_argument("--expression_suffix", type=str, default="_code_savgol_boundbox+smooth_expression")
    parser.add_argument("--audio_dir", type=str, default="audios")
    parser.add_argument("--video_dir", type=str, default="videos")
    parser.add_argument("--keys_file", type=str, default="keys.txt")
    parser.add_argument("--output_dir", type=str, default="processed_data")
    parser.add_argument("--no_lmdb", action="store_true", help="skip the LMDB store (pickle only)")
    args = parser.parse_args()

    root = Path(args.dataset_root)
    out_dir = root / args.output_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    pkl_path = out_dir / f"processed_data_{args.goal_fps}fps_v3.pkl"
    lmdb_path = out_dir / f"processed_data_{args.goal_fps}fps_v3.lmdb"
    error_path = out_dir / "error_files_v3.pkl"

    with open(root / args.keys_file) as f:
        valid_keys = [line.strip() for line in f if line.strip()]

    assembled: Dict[str, dict] = {}
    error_files = []
    if error_path.exists():
        with open(error_path, "rb") as f:
            error_files = pickle.load(f)

    env = txn = None
    if not args.no_lmdb:
        try:
            import lmdb

            env = lmdb.open(str(lmdb_path), map_size=1_099_511_627_776)
            # resume: skip keys already assembled
            with env.begin() as rtxn:
                done = {k.decode() for k, _ in rtxn.cursor()}
                for k in done:
                    assembled[k] = pickle.loads(rtxn.get(k.encode()))
            valid_keys = [k for k in valid_keys if k not in assembled]
            txn = env.begin(write=True)
        except ImportError:
            print("lmdb not available; writing the chunked pickle only")
            env = None

    import cv2

    for i, vid in enumerate(valid_keys):
        try:
            print(f"[{i}/{len(valid_keys)}] {vid}")
            with open(root / args.head_orientation_dir / f"{vid}.pkl", "rb") as f:
                head = np.asarray(pickle.load(f))
            with open(root / args.expression_code_dir / f"{vid}{args.expression_suffix}.pkl", "rb") as f:
                exp = pickle.load(f)
            if hasattr(exp, "detach"):
                exp = exp.detach().cpu().numpy()
            audio_file = next((root / args.audio_dir).glob(f"{vid}.*"))
            audio, sr = load_audio_any(audio_file)

            cap = cv2.VideoCapture(str(root / args.video_dir / f"{vid}.mp4"))
            fps = cap.get(cv2.CAP_PROP_FPS)
            cap.release()

            clip = resample_clip(head, np.asarray(exp), np.asarray(audio), fps, sr, args.goal_fps, args.goal_sr)
            assembled[vid] = clip
            if txn is not None:
                txn.put(vid.encode(), pickle.dumps(clip))
                if i % 100 == 0:
                    txn.commit()
                    txn = env.begin(write=True)
        except Exception as e:
            error_files.append(vid)
            with open(error_path, "wb") as f:
                pickle.dump(error_files, f)
            print(f"Error processing video {vid}: {e!r}")

    if txn is not None:
        txn.commit()
        env.close()
    save_chunked_pickle(assembled, pkl_path)
    print(f"assembled {len(assembled)} clips -> {pkl_path}")


if __name__ == "__main__":
    main()
