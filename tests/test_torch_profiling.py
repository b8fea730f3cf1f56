"""The port's profiling hooks (``msmd_tpu_torch/utils/profiling.py``) on
the CPU: ``trace`` writes a Chrome trace of what ran inside it;
``StepTimer``'s summary equals the JAX package's on the same durations;
``device_memory_stats`` reports no device here; ``Trainer.fit(profile_dir=)``
traces the iterations of its window, and closes a window the run ends
inside, at the tiny geometry. ``measure.profiled`` (on faked profiler
sessions) takes again a session that kept fewer kernel records than
launch calls, and raises when none is whole; the call sits between two
idle pauses inside each session."""

import json

import numpy as np
import pytest
import torch

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
from msmd_tpu_torch.utils.profiling import StepTimer, device_memory_stats, trace

from test_torch_common import TINY_AUDIO


def _events(path):
    return [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(tmp_path / "tb", rank=3):
        (x @ x).relu()
    (path,) = list((tmp_path / "tb").glob("*_rank3_*.pt.trace.json"))
    names = _events(path)
    assert any("aten::mm" in n for n in names) and any("aten::relu" in n for n in names)


def test_step_timer_summary_equals_jax(monkeypatch):
    from msmd_tpu.utils.profiling import StepTimer as JTimer

    durations = [0.5, 0.25, 1.0, 0.125, 0.75]
    ticks = iter(np.cumsum([0.0] + [v for d in durations for v in (d, 0.0)]))
    monkeypatch.setattr("time.perf_counter", lambda: float(next(ticks)))
    timer = StepTimer()
    for _ in durations:
        with timer:
            pass
    assert timer.durations == durations
    want = JTimer()
    want.durations = list(durations)
    assert timer.summary() == want.summary()
    assert StepTimer().summary() == {}


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() == {"cpu": {}}


@pytest.mark.parametrize("max_iter, steps, stopped_by", [(3, (1, 2), "window"), (2, (2, 5), "end of run")])
def test_fit_writes_a_trace_of_its_window(tmp_path, capsys, max_iter, steps, stopped_by):
    from msmd_tpu_torch.train.trainer import Trainer

    cfg = MSMDConfig(feature_dim=16, n_heads=2, n_layers=1, mlp_ratio=2, d_style=16, n_motions=8, n_prev_motions=4,
                     n_diff_steps=2, num_of_basis=2, batch_size=2, max_iter=max_iter, save_iter=100, val_iter=0,
                     log_iter=100, compute_dtype="float32", fused_ffn_train=True)
    trainer = Trainer(cfg, tmp_path / "exp", audio_config=AudioEncoderConfig(**TINY_AUDIO), device="cpu")
    rs = np.random.RandomState(0)
    L = cfg.n_audio_samples
    batch = {"audio_0": rs.randn(2, L).astype(np.float32), "audio_1": rs.randn(2, L).astype(np.float32),
             "motion_0": rs.randn(2, 8, 67).astype(np.float32), "motion_1": rs.randn(2, 8, 67).astype(np.float32),
             "shape_0": np.zeros((2, 8, 100), np.float32), "shape_1": np.zeros((2, 8, 100), np.float32)}
    steps_run = []
    real = trainer.opt.step
    trainer.opt.step = lambda: steps_run.append(1) or real()
    trainer.fit(iter([batch] * (max_iter + 1)), profile_dir=str(tmp_path / "prof"), profile_steps=steps)
    trainer.close()
    (path,) = list((tmp_path / "prof").glob("*_rank0_*.pt.trace.json"))
    assert f"Wrote profiler trace to {path}" in capsys.readouterr().out
    names = _events(path)
    traced = sum(n == "aten::linear" for n in names)
    assert traced > 0 and len(steps_run) == max_iter + 1, stopped_by
    assert any("Optimizer.step" in n or "aten::_foreach" in n or "adam" in n.lower() for n in names)


def _fake_sessions(monkeypatch, sessions):
    """torch.profiler.profile replaced by sessions whose events are given:
    (name, device, start) triples; no card needed."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    sessions = iter(sessions)

    class Session:
        def __init__(self, activities):
            self._events = [SimpleNamespace(name=n, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                                            time_range=SimpleNamespace(start=t)) for n, dev, t in next(sessions)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self._events

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


LOST = [("cudaLaunchKernelExC", False, 0), ("cudaLaunchKernelExC", False, 1)]
WHOLE = LOST + [("gemm_train_kernel", True, 3), ("gemm_train_kernel", True, 2), ("Memset (Device)", True, 4),
                ("cudaMemsetAsync", False, 2)]


@pytest.mark.parametrize("verdicts,calls", [((True,), 1), ((False, True), 2), ((False, False, True), 3)])
def test_profiled_takes_again_a_session_without_device_records(monkeypatch, verdicts, calls):
    """A session with fewer kernel records than runtime launch calls is
    taken again (the call runs again); the first whole one is returned,
    its kernels in start order without the memset."""
    from msmd_tpu_torch import measure

    _fake_sessions(monkeypatch, [WHOLE if whole else LOST for whole in verdicts])
    monkeypatch.setattr(measure.profiled, "lost", [])
    ran = []
    prof = measure.profiled(lambda: ran.append(1))
    assert len(ran) == calls and measure.profiled.lost == [(0, 2)] * (calls - 1)
    assert [(e.name, e.time_range.start) for e in measure.kernel_events(prof)] == [("gemm_train_kernel", 2),
                                                                                 ("gemm_train_kernel", 3)]


def test_profiled_raises_after_its_sessions_and_follows_the_ranks_verdict(monkeypatch):
    """Never whole in ``tries`` sessions: it raises. A whole session that
    another rank's verdict overrules (``agree``) is taken again too."""
    from msmd_tpu_torch import measure

    tries = measure.PROFILE_TRIES
    _fake_sessions(monkeypatch, [LOST] * tries)
    monkeypatch.setattr(measure.profiled, "lost", [])
    with pytest.raises(RuntimeError, match=f"fewer kernel records than launch calls in {tries} sessions"):
        measure.profiled(lambda: None)
    assert measure.profiled.lost == [(0, 2)] * tries
    _fake_sessions(monkeypatch, [WHOLE, WHOLE])
    monkeypatch.setattr(measure.profiled, "lost", [])
    verdicts = iter([False, True])
    seen = []
    measure.profiled(lambda: None, agree=lambda whole: seen.append(whole) or next(verdicts))
    assert seen == [True, True] and measure.profiled.lost == [(2, 2)]


def test_profiled_keeps_idle_time_inside_each_end_of_the_session(monkeypatch):
    """The call sits between two idle pauses of ``PROFILE_PAD_S`` inside
    the profiler session, and the session ends after a synchronize."""
    import time

    from msmd_tpu_torch import measure

    _fake_sessions(monkeypatch, [WHOLE])
    seen = []
    Session = torch.profiler.profile
    monkeypatch.setattr(Session, "__enter__", lambda self: seen.append("enter") or self)
    monkeypatch.setattr(Session, "__exit__", lambda self, *exc: seen.append("exit") or False)
    monkeypatch.setattr(time, "sleep", lambda s: seen.append(("sleep", s)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: seen.append("sync"))
    measure.profiled(lambda: seen.append("call"))
    pad = ("sleep", measure.PROFILE_PAD_S)
    assert measure.PROFILE_PAD_S > 0 and seen == ["sync", "enter", pad, "call", "sync", pad, "exit"]
