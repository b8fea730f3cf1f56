"""Profiling hooks (the port of ``msmd_tpu/utils/profiling.py``; the
reference has none but ad-hoc GPU-memory prints, training_script.py:33-40).

- ``trace(log_dir)``: a context manager around ``torch.profiler``: CPU and
  CUDA activity on the card (CPU only without one), written as a Chrome
  trace file under ``log_dir`` (TensorBoard's profiler plugin and
  ``chrome://tracing`` read it). ``Tracer`` is the same as start / stop,
  for a trace that spans loop iterations (``Trainer.fit(profile_dir=)``).
- ``StepTimer``: wall-clock per-step timing with percentile summaries.
- ``device_memory_stats()``: memory in use, its peak and the limit of
  every CUDA device, in MB.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


class Tracer:
    """A ``torch.profiler`` trace that ``stop`` writes to
    ``<log_dir>/<host>_rank<rank>_<ms>.pt.trace.json``."""

    def __init__(self, log_dir, rank: int = 0):
        self.log_dir, self.rank = Path(log_dir), rank
        self._prof = None

    @property
    def running(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self) -> Path:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / f"{socket.gethostname()}_rank{self.rank}_{int(time.time() * 1e3)}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        return path


@contextlib.contextmanager
def trace(log_dir, rank: Optional[int] = None):
    """Trace everything inside; the file is written on exit. ``rank``
    defaults to the ``RANK`` of the environment (0 alone)."""
    tracer = Tracer(log_dir, int(os.environ.get("RANK", 0)) if rank is None else rank)
    tracer.start()
    try:
        yield tracer
    finally:
        tracer.stop()


class StepTimer:
    def __init__(self):
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        return {
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "max_s": float(d.max()),
            "steps_per_sec": float(1.0 / max(d.mean(), 1e-12)),
            "n": int(len(d)),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """``{"cuda:i": {mb_in_use, peak_mb_in_use, mb_limit}}`` for every
    CUDA device (reference analogue: print_GPU_usage,
    training_script.py:33-40); ``{"cpu": {}}`` without one, as the JAX
    package reports a device that keeps no statistics."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    mb = 1024 ** 2
    return {f"cuda:{i}": {"mb_in_use": torch.cuda.memory_allocated(i) / mb,
                          "peak_mb_in_use": torch.cuda.max_memory_allocated(i) / mb,
                          "mb_limit": torch.cuda.get_device_properties(i).total_memory / mb}
            for i in range(torch.cuda.device_count())}
