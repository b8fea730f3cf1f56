"""Host-side data pipeline: chunked-pickle motion/audio datasets (the
port's own copy of ``msmd_tpu/data/pickle_dataset.py``).

NumPy rebuild of the reference data layer (reference:
datasets.py:27-505): chunked-pickle loading, 30->25 fps interp1d
resampling, per-clip audio z-scoring, random cropping of TWO adjacent
100-frame windows (the windowed-autoregression training pair),
coefficient z-scoring, inverse-size weighted multi-dataset sampling,
and a fixed 64,000-sample audio collate.

The output of every batch is a dict of fixed-shape NumPy arrays; the
trainer (``msmd_tpu_torch/train``) moves them to the device.
"""

from __future__ import annotations

import pickle
import threading
import queue as queue_mod
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

try:
    from scipy.interpolate import interp1d

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


def load_chunked_pickle(file_path) -> Dict:
    """Merge every chunk of a chunked pickle into one dict (reference:
    datasets.py:143-165)."""
    data: Dict = {}
    with open(file_path, "rb") as f:
        while True:
            try:
                data.update(pickle.load(f))
            except EOFError:
                break
    return data


def _resample_axis0(arr: np.ndarray, new_len: int) -> np.ndarray:
    """interp1d-style linear resampling over axis 0 (reference:
    datasets.py:208-227 uses scipy interp1d on [0, 1] grids)."""
    n = arr.shape[0]
    if new_len == n:
        return arr
    x = np.linspace(0, 1, num=n)
    xnew = np.linspace(0, 1, num=new_len)
    if _HAVE_SCIPY:
        return interp1d(x, arr, axis=0)(xnew).astype(arr.dtype)
    # numpy fallback (identical for linear interpolation on shared grids)
    out = np.empty((new_len,) + arr.shape[1:], arr.dtype)
    flat = arr.reshape(n, -1)
    res = np.empty((new_len, flat.shape[1]), arr.dtype)
    for j in range(flat.shape[1]):
        res[:, j] = np.interp(xnew, x, flat[:, j])
    return res.reshape((new_len,) + arr.shape[1:])


def incremental_mean_and_std(clips: Sequence[Dict], exp_dim: int = 64):
    """Streaming mean/std of expression (64) and pose (3) over FULL clips.

    Library helper; note the dataset itself now computes its stats with
    the reference's sampling instead (random two-window crops including
    short-clip zero padding — see
    ``MotionClipDataset._stats_from_random_crops``, reference:
    datasets.py:93-139 + 250-257)."""
    exp_sum = exp_sq = pose_sum = pose_sq = 0.0
    n = 0
    for clip in clips:
        e = clip["expression_code"][:, :exp_dim].astype(np.float64)
        p = clip["head_orientation"].astype(np.float64)
        exp_sum = exp_sum + e.sum(0)
        exp_sq = exp_sq + (e**2).sum(0)
        pose_sum = pose_sum + p.sum(0)
        pose_sq = pose_sq + (p**2).sum(0)
        n += e.shape[0]
    exp_mean = exp_sum / n
    pose_mean = pose_sum / n
    exp_std = np.sqrt(np.maximum(exp_sq / n - exp_mean**2, 0))
    pose_std = np.sqrt(np.maximum(pose_sq / n - pose_mean**2, 0))
    return (
        exp_mean.astype(np.float32),
        exp_std.astype(np.float32),
        pose_mean.astype(np.float32),
        pose_std.astype(np.float32),
    )


class MotionClipDataset:
    """One processed pickle + split file -> two-adjacent-window training
    samples (reference: DatasetPickle, datasets.py:141-505)."""

    def __init__(
        self,
        pkl_file=None,
        split_file=None,
        coef_stats_file=None,
        original_fps: int = 30,
        coef_fps: int = 25,
        n_motions: int = 100,
        clip_len: int = 100,
        no_head_pose: bool = False,
        pre_loaded_raw_dataset: Optional[Dict] = None,
        valid_keys_file=None,
        random_crop: bool = True,
        batch_overfit_size: int = -1,
        exp_dim: int = 64,
        seed: int = 0,
    ):
        self.rng = np.random.RandomState(seed)
        # split keys
        self.file_names: List[str] = []
        valid_ids = None
        if valid_keys_file is not None:
            with open(valid_keys_file) as f:
                valid_ids = {line.strip() for line in f}
        with open(split_file) as f:
            for line in f:
                name = line.strip()
                if name and (valid_ids is None or name in valid_ids):
                    self.file_names.append(name)
        if batch_overfit_size > 0:
            # overfit smoke mode: k items, no random padding
            # (reference: datasets.py:34-38,189-191)
            self.file_names = self.file_names[:batch_overfit_size]
            random_crop = False

        raw = pre_loaded_raw_dataset if pre_loaded_raw_dataset is not None else load_chunked_pickle(pkl_file)
        self.data = {}
        for key in self.file_names:
            clip = raw[key]
            if original_fps != coef_fps:
                n_new = int(round(clip["expression_code"].shape[0] / original_fps * coef_fps))
                clip = {
                    "audio": clip["audio"],
                    "expression_code": _resample_axis0(np.asarray(clip["expression_code"]), n_new),
                    "head_orientation": _resample_axis0(np.asarray(clip["head_orientation"]), n_new),
                }
            self.data[key] = clip

        self.coef_fps = coef_fps
        self.clip_len = clip_len
        self.audio_unit = 16000.0 / coef_fps  # samples per frame (datasets.py:238)
        self.n_motions = n_motions
        self.n_audio_samples = round(self.audio_unit * n_motions)
        self.coef_total_len = int(n_motions * 2.1)  # (datasets.py:241)
        self.audio_total_len = round(self.audio_unit * self.coef_total_len)
        self.random_crop = random_crop
        self.no_head_pose = no_head_pose
        self.exp_dim = exp_dim
        self.entries = self.file_names

        if coef_stats_file is not None:
            stats = dict(np.load(coef_stats_file))
            self.coef_stats = {k: np.asarray(v, np.float32) for k, v in stats.items()}
        else:
            em, es, pm, ps = self._stats_from_random_crops()
            self.coef_stats = {"exp_mean": em, "exp_std": es, "pose_mean": pm, "pose_std": ps}

    def __len__(self):
        return len(self.entries)

    def _normalize(self, exp: np.ndarray, pose: np.ndarray):
        s = self.coef_stats
        exp = (exp - s["exp_mean"]) / (s["exp_std"] + 1e-9)
        pose = (pose - s["pose_mean"]) / (s["pose_std"] + 1e-9)
        return exp, pose

    def _crop_two_windows(self, exp: np.ndarray, pose: np.ndarray, audio: np.ndarray):
        """The two-adjacent-window random crop, UNNORMALIZED (reference:
        datasets.py:281-338). Shared by __getitem__ and the stats pass
        (which the reference runs through the same __getitem__ before
        coef_stats exists). Returns [(audio_w, exp_w, pose_w)] * 2."""
        total, each = self.coef_total_len, self.clip_len
        cur = exp.shape[0]

        if self.random_crop and cur > total:
            s1 = self.rng.randint(0, cur - total + 1)
        elif self.random_crop and cur == total:
            s1 = 0
        else:
            # pad a short clip to total length, split randomly front/back
            # (reference: datasets.py:292-318)
            frames_to_pad = max(total - cur, 0)
            front = self.rng.randint(0, frames_to_pad) if (self.random_crop and frames_to_pad > 0) else 0
            back = frames_to_pad - front
            exp = np.pad(exp, ((front, back), (0, 0)))
            pose = np.pad(pose, ((front, back), (0, 0)))
            audio = np.pad(audio, (int(round(front * self.audio_unit)), int(round(back * self.audio_unit))))
            min_audio = int(round(total * self.audio_unit))
            if audio.shape[0] < min_audio:
                audio = np.pad(audio, (0, min_audio - audio.shape[0]))
            s1 = 0

        windows = []
        for w in range(2):
            a, b = s1 + w * each, s1 + (w + 1) * each
            windows.append(
                (
                    audio[int(a * self.audio_unit) : int(b * self.audio_unit)],
                    exp[a:b, : self.exp_dim],
                    pose[a:b],
                )
            )
        return windows

    def _stats_from_random_crops(self, exp_dim: Optional[int] = None):
        """Reference stats semantics (datasets.py:93-139 driven through
        __getitem__ at :250-257): stream mean/std over each clip's
        random-cropped two windows — INCLUDING the zero padding of short
        clips — rather than over full clips."""
        exp_dim = exp_dim if exp_dim is not None else self.exp_dim
        exp_sum = exp_sq = pose_sum = pose_sq = 0.0
        n = 0
        for key in self.entries:
            clip = self.data[key]
            exp = np.asarray(clip["expression_code"], np.float32)
            pose = np.asarray(clip["head_orientation"], np.float32)
            audio = np.asarray(clip["audio"], np.float32)
            for _, e_w, p_w in self._crop_two_windows(exp, pose, audio):
                e = e_w[:, :exp_dim].astype(np.float64)
                p = p_w.astype(np.float64)
                exp_sum = exp_sum + e.sum(0)
                exp_sq = exp_sq + (e**2).sum(0)
                pose_sum = pose_sum + p.sum(0)
                pose_sq = pose_sq + (p**2).sum(0)
                n += e.shape[0]
        exp_mean = exp_sum / n
        pose_mean = pose_sum / n
        exp_std = np.sqrt(np.maximum(exp_sq / n - exp_mean**2, 0))
        pose_std = np.sqrt(np.maximum(pose_sq / n - pose_mean**2, 0))
        return (
            exp_mean.astype(np.float32),
            exp_std.astype(np.float32),
            pose_mean.astype(np.float32),
            pose_std.astype(np.float32),
        )

    def __getitem__(self, index: int):
        clip = self.data[self.entries[index]]
        audio = np.asarray(clip["audio"], np.float32)
        exp = np.asarray(clip["expression_code"], np.float32)
        pose = np.asarray(clip["head_orientation"], np.float32)

        # per-clip audio z-score BEFORE padding (reference: datasets.py:269-271)
        a_mean, a_std = float(audio.mean()), float(audio.std())
        audio = (audio - a_mean) / (a_std + 1e-5)

        each = self.clip_len
        windows = []
        for audio_w, e_w, p_w in self._crop_two_windows(exp, pose, audio):
            e_n, p_n = self._normalize(e_w, p_w)
            windows.append((audio_w, np.concatenate([e_n, p_n], axis=-1)))

        shape = np.zeros((each, 100), np.float32)  # zero shape coefs (datasets.py:355)
        return (
            [windows[0][0], windows[1][0]],
            [
                {"shape": shape, "motion": windows[0][1]},
                {"shape": shape.copy(), "motion": windows[1][1]},
            ],
            (a_mean, a_std),
        )

    # ------------------------------------------------------------------
    def query_for_video(self, index: int):
        """Full-clip access for eval/inference (reference: datasets.py:391-421)."""
        clip = self.data[self.entries[index]]
        audio = np.asarray(clip["audio"], np.float32)
        a_mean, a_std = float(audio.mean()), float(audio.std())
        audio = (audio - a_mean) / (a_std + 1e-5)
        exp, pose = self._normalize(
            np.asarray(clip["expression_code"], np.float32)[:, : self.exp_dim],
            np.asarray(clip["head_orientation"], np.float32),
        )
        motion = np.concatenate([exp, pose], axis=-1)
        shape = np.zeros((motion.shape[0], 100), np.float32)
        return audio, {"shape": shape, "motion": motion}, (a_mean, a_std)

    def get_k_indices_for_each_emotion(self, k: int = 2):
        """RAVDESS emotion-keyed sampling (filename field 3 is the emotion
        code "01".."08" — reference: datasets.py:370-389)."""
        emotions = [f"{i:02d}" for i in range(1, 9)]
        out = {}
        for emotion in emotions:
            matches = [i for i, e in enumerate(self.entries) if len(e.split("-")) > 2 and e.split("-")[2] == emotion]
            out[emotion] = list(self.rng.choice(matches, size=min(k, len(matches)), replace=False)) if matches else []
        return out


# ---------------------------------------------------------------------------
# collate + samplers + loader
# ---------------------------------------------------------------------------

def pad_or_trim_audio(a: np.ndarray, target: int = 64000) -> np.ndarray:
    if a.shape[0] < target:
        return np.pad(a, (0, target - a.shape[0]))
    return a[:target]


def collate(batch, audio_target_len: int = 64000) -> Dict[str, np.ndarray]:
    """Fixed-shape batch dict (reference collate: datasets.py:423-505).
    audio is padded/trimmed to exactly 100 x 640 samples. On ragged
    clips the stack error reports every per-item shape (the reference's
    only runtime sanitizer, datasets.py:477-493)."""
    columns = {
        "audio_0": [pad_or_trim_audio(b[0][0], audio_target_len) for b in batch],
        "audio_1": [pad_or_trim_audio(b[0][1], audio_target_len) for b in batch],
        "motion_0": [b[1][0]["motion"] for b in batch],
        "motion_1": [b[1][1]["motion"] for b in batch],
        "shape_0": [b[1][0]["shape"] for b in batch],
        "shape_1": [b[1][1]["shape"] for b in batch],
    }
    try:
        out = {k: np.stack(v) for k, v in columns.items()}
    except ValueError as e:
        shapes_info = {k: [np.shape(x) for x in v] for k, v in columns.items()}
        raise ValueError(
            f"Failed to stack tensors. Shapes: {shapes_info}. Original error: {e}"
        ) from e
    out["audio_mean"] = np.float32(np.mean([b[2][0] for b in batch]))
    out["audio_std"] = np.float32(np.mean([b[2][1] for b in batch]))
    return out


class WeightedConcatSampler:
    """Inverse-size weighted sampling with replacement over concatenated
    datasets (reference: datasets.py:68-80)."""

    def __init__(self, datasets: Sequence[MotionClipDataset], seed: int = 0):
        self.datasets = list(datasets)
        sizes = [len(d) for d in self.datasets]
        self.offsets = np.cumsum([0] + sizes[:-1])
        weights = np.concatenate([np.full(n, 1.0 / n) for n in sizes])
        self.p = weights / weights.sum()
        self.total = sum(sizes)
        self.rng = np.random.RandomState(seed)

    def sample(self, n: int) -> np.ndarray:
        return self.rng.choice(self.total, size=n, replace=True, p=self.p)

    def fetch(self, flat_index: int):
        for d, off in zip(self.datasets[::-1], self.offsets[::-1]):
            if flat_index >= off:
                return d[int(flat_index - off)]
        raise IndexError(flat_index)


class BatchLoader:
    """Infinite batched iterator with a background prefetch thread (in
    place of DataLoader workers + the reference's infinite_data_loader,
    training_script.py:28-31)."""

    def __init__(self, sampler: WeightedConcatSampler, batch_size: int, prefetch: int = 4, audio_target_len: int = 64000):
        self.sampler = sampler
        self.batch_size = batch_size
        self.audio_target_len = audio_target_len
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self):
        idx = self.sampler.sample(self.batch_size)
        return collate([self.sampler.fetch(i) for i in idx], self.audio_target_len)

    def _worker(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._make_batch(), timeout=1.0)
            except queue_mod.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def __len__(self) -> int:
        """Batches per epoch: the reference DataLoader draws
        len(dataset) weighted samples per epoch with drop_last=True
        (datasets.py:80-87), so one epoch = total // batch_size batches."""
        return self.sampler.total // self.batch_size

    def close(self):
        self._stop.set()


def get_dataset(cfg, batch_overfit_size: int = -1, seed: int = 0):
    """Build (train_datasets, val_datasets, train_loader, val_loader)
    (reference: datasets.py:27-91).

    ``ravdess+celebv-text-medium`` expects under ``cfg.data_root``:
      processed_data_30fps_medium_v3.pkl (+ key splits)   [celebv-text]
      ravdess/processed_ravdess_30fps_v3.pkl (+ splits)   [ravdess]
    (the reference hardcodes /data/ravdess — we root both under
    data_root for portability). Any other dataset_type is treated as a
    single chunked-pickle set named ``<dataset_type>.pkl``.
    """
    root = Path(cfg.data_root)
    common = dict(
        original_fps=30,
        coef_fps=cfg.fps,
        n_motions=cfg.n_motions,
        clip_len=cfg.n_motions,
        no_head_pose=cfg.no_head_pose,
        batch_overfit_size=batch_overfit_size,
    )

    def build(name, base, split, **kw):
        return MotionClipDataset(base / f"{name}.pkl", base / f"{name}_keys_{split}.txt", seed=seed, **common, **kw)

    if cfg.dataset_type == "ravdess+celebv-text-medium":
        celebv = "processed_data_30fps_medium_v3"
        rav_base = root / "ravdess" if (root / "ravdess").exists() else root
        rav = "processed_ravdess_30fps_v3"
        raw = load_chunked_pickle(root / f"{celebv}.pkl")
        train_sets = [
            build(celebv, root, "train", pre_loaded_raw_dataset=raw),
            build(rav, rav_base, "train"),
        ]
        val_sets = [
            build(celebv, root, "valid", pre_loaded_raw_dataset=raw),
            build(rav, rav_base, "valid"),
        ]
    else:
        name = cfg.dataset_type
        train_sets = [build(name, root, "train")]
        val_sets = [build(name, root, "valid")]

    audio_len = cfg.n_audio_samples
    train_loader = BatchLoader(WeightedConcatSampler(train_sets, seed), cfg.batch_size, audio_target_len=audio_len)
    val_loader = BatchLoader(WeightedConcatSampler(val_sets, seed + 1), cfg.batch_size, audio_target_len=audio_len)
    return train_sets, val_sets, train_loader, val_loader
