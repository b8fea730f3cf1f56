"""Profiling hooks (the port of ``msmd_tpu/utils/profiling.py``; the
reference has none but ad-hoc GPU-memory prints, training_script.py:33-40).

- ``trace(log_dir)``: a context manager around ``torch.profiler``: CPU and
  CUDA activity on the card (CPU only without one), written as a Chrome
  trace file under ``log_dir`` (TensorBoard's profiler plugin and
  ``chrome://tracing`` read it). ``Tracer`` is the same as start / stop,
  for a trace that spans loop iterations (``Trainer.fit(profile_dir=)``).
- ``span(name)``: the program's spans at its layer boundaries, every name
  starting ``msmd.``. Inside a profiler session (``trace``, ``Tracer`` or
  any other ``torch.profiler`` session) a span is a ``record_function``
  range, in the same timeline and on the same clock as the kernels,
  copies and fills it launched; outside one it costs one check of whether
  a session is on.
- ``count(name, n)``, ``counters()``: integer counters of the program's
  work, always on, and a snapshot of them.
- ``device_memory_stats()``: memory in use, its peak and the limit of
  every CUDA device, in MB.

The spans and what each covers:

- ``msmd.audio_encoder``: ``MSMD.extract_audio_feature`` (HuBERT, the
  resampling, the projection), for every caller; with WavLM inside it
  ``msmd.audio_encoder.features`` (the conv front),
  ``msmd.audio_encoder.rel_bias`` (the heads' table of offsets, once a
  call, and each layer's gate, inside ``.layers``) and
  ``msmd.audio_encoder.layers`` (the encoder's layers);
- ``msmd.sample.setup``: ``sample`` from its entry to the first denoiser
  launch (the CFG stacks, the bf16 copy of the denoiser, the memory K/V,
  the kernels' packed arguments, the tables);
- ``msmd.sample.steps``: ``sample``'s step loop, or the batch-1 kernels'
  launches (K3, or K4 a step);
- ``msmd.flame.decode``: ``ops/kernels/lbs.py::flame_vertices`` (K5);
- ``msmd.stream.gather``, ``msmd.stream.scatter``, ``msmd.stream.resolve``:
  ``StreamingBatcher``'s round: the ready streams, slots, host arrays,
  draws and uploads; the carries, the pinned copy of the motion and its
  event; a round's wait and hand-out;
- ``msmd.train.loss``, ``msmd.train.backward``, ``msmd.train.optimizer``:
  ``train/loop.py::train_step``'s three parts.

The counters: ``msmd.frames.sampled``, the rows times ``n_motions`` of
every window ``infer_coeffs`` and ``StreamingBatcher.step`` sample (every
one of a round's ``max_slots`` rows); ``msmd.frames.kept``, the frames
they hand back, the padding trimmed and the unserved slots left out;
``msmd.k10.calls`` (K10's forward and backward calls on the card),
``msmd.k10.fwd_rows`` / ``msmd.k10.bwd_rows`` (their query rows, entries
times L, summed), ``msmd.k10.plain_calls`` (WavLM attentions on the card
longer than K10 takes, run by its plain twin); ``msmd.wavlm.bias_tables`` (WavLM's tables of offsets
built: one an encoder call).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Dict, Optional

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


_NO_SPAN = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


def span(name: str):
    """A context manager: a ``torch.profiler.record_function`` range named
    ``name`` while a profiler session is on, else nothing. The check costs
    a fraction of a microsecond; ``record_function`` itself costs several
    even with no session, so it is entered only inside one."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a Python int: a tensor would wait for the device) to the
    counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter; the difference of two is the work done
    between them."""
    return dict(_COUNTS)


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
