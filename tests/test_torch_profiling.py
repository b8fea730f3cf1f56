"""The port's profiling hooks (``msmd_tpu_torch/utils/profiling.py``) on
the CPU: ``trace`` writes a Chrome trace of what ran inside it;
``device_memory_stats`` reports no device here; ``Trainer.fit(profile_dir=)``
traces the iterations of its window, and closes a window the run ends
inside, at the tiny geometry, with the train step's spans in it. The
program's spans: in a profiled ``infer_coeffs`` call (the batch-1 kernel
route and the decoder-kernel loop) and in a ``StreamingBatcher`` round
they follow each other as the layers do; with no session on, ``span``
never enters ``record_function``. The counters: a padded two-window call
of R repetitions samples 2 R n_motions frames and keeps R times the
clip's; a round with an empty slot counts its row as sampled, not kept.
``measure.profiled`` (on faked profiler sessions) takes again a session
that kept fewer kernel records than launch calls, and raises when none
is whole; the call sits between two idle pauses inside each session."""

import json

import numpy as np
import pytest
import torch

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
from msmd_tpu_torch.inference_lib import infer_coeffs
from msmd_tpu_torch.serving import StreamingBatcher
from msmd_tpu_torch.utils.profiling import counters, device_memory_stats, span, trace

from test_torch_common import TINY_AUDIO, tiny_cfg_kwargs


def _events(path):
    return [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]]


def _ranges(path):
    """The program's spans in a Chrome trace: (name, start, end) in start order."""
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name", "").startswith("msmd.") and e.get("cat") == "user_annotation"), key=lambda r: r[1])


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(tmp_path / "tb", rank=3):
        (x @ x).relu()
    (path,) = list((tmp_path / "tb").glob("*_rank3_*.pt.trace.json"))
    names = _events(path)
    assert any("aten::mm" in n for n in names) and any("aten::relu" in n for n in names)


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() == {"cpu": {}}


@pytest.fixture(scope="module")
def models():
    """The tiny model at f32 (the plain modules) and at bf16 (the kernels'
    plain versions: K3 at batch 1, K1 per-entry at Be > 4)."""
    from msmd_tpu_torch.models.diffusion import get_diffusion_model

    cfg = MSMDConfig(**tiny_cfg_kwargs())
    return {dt: get_diffusion_model(cfg, audio_config=AudioEncoderConfig(**TINY_AUDIO), dtype=dt, device="cpu",
                                    seed=3) for dt in (torch.float32, torch.bfloat16)}


def _padded_call(model, R):
    """``infer_coeffs`` over a clip of one and a half windows: two windows,
    the last padded. Returns the coefficients."""
    audio = np.random.RandomState(R).randn(int(model.cfg.n_audio_samples * 1.5)).astype(np.float32)
    return infer_coeffs(model, audio, np.zeros((1, 100), np.float32), style_feats=np.zeros((1, 16), np.float32),
                        n_repetitions=R, generator=torch.Generator().manual_seed(R), device="cpu")


def _round(model, slots=3, pipeline_depth=1):
    """A batcher with two streams over ``slots`` slots: one a full window,
    one a final partial window. Returns the batcher before its round."""
    cfg = model.cfg
    bat = StreamingBatcher(model, max_slots=slots, pipeline_depth=pipeline_depth, device="cpu")
    rs = np.random.RandomState(7)
    for seed, (sid, n) in enumerate((("full", cfg.n_audio_samples), ("part", cfg.n_audio_samples - 1500))):
        bat.add_stream(sid, seed=seed, style=np.zeros(cfg.d_style, np.float32))
        bat.push_audio(sid, rs.randn(n).astype(np.float32), final=True)
    return bat


def _profiled_spans(fn):
    """The program's spans as a CPU profiler session records them, in start
    order: (name, start, end)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("msmd.")), key=lambda r: r[1])


def _disjoint(spans):
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("dtype, R", [(torch.bfloat16, 1), (torch.bfloat16, 3), (torch.float32, 2)])
def test_spans_of_an_infer_coeffs_call_follow_its_layers(models, dtype, R):
    """The clip's audio features once, then each window's set-up and steps
    (the batch-1 kernel's route at R = 1, the step loop otherwise), one
    after the other and none inside another."""
    spans = _profiled_spans(lambda: _padded_call(models[dtype], R))
    steps = ["msmd.sample.setup", "msmd.sample.steps"]
    assert [n for n, _, _ in spans] == ["msmd.audio_encoder"] + steps * 2
    assert _disjoint(spans)


def test_spans_of_a_batcher_round_follow_its_phases(models):
    """A round: gather, the audio encoder, the sampler's set-up and steps,
    scatter, and at depth 1 the round's own resolve."""
    bat = _round(models[torch.float32])
    spans = _profiled_spans(bat.step)
    assert [n for n, _, _ in spans] == ["msmd.stream.gather", "msmd.audio_encoder", "msmd.sample.setup",
                                        "msmd.sample.steps", "msmd.stream.scatter", "msmd.stream.resolve"]
    assert _disjoint(spans)


def test_span_without_a_session_never_enters_record_function(monkeypatch, models):
    """Outside a profiler session a span is the check alone; inside one,
    every span is a ``record_function`` range."""
    entered = []

    class Counting:
        def __init__(self, name, args=None):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    model = models[torch.bfloat16]
    with span("msmd.anything"):
        _padded_call(model, 1)
    _round(model).step()
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("msmd.anything"):
            _padded_call(model, 1)
    assert entered == ["msmd.anything", "msmd.audio_encoder"] + ["msmd.sample.setup", "msmd.sample.steps"] * 2


def _delta(before):
    after = counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in ("msmd.frames.sampled", "msmd.frames.kept")}


@pytest.mark.parametrize("R", [1, 3])
def test_counters_of_a_padded_two_window_call(models, R):
    model = models[torch.float32]
    cfg = model.cfg
    clip_frames = int(cfg.n_audio_samples * 1.5 / 16000 * cfg.fps)
    before = counters()
    out = _padded_call(model, R)
    assert out.shape[:2] == (R, clip_frames) and clip_frames < 2 * cfg.n_motions
    assert _delta(before) == {"msmd.frames.sampled": 2 * R * cfg.n_motions, "msmd.frames.kept": R * clip_frames}


@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_counters_of_a_round_with_an_empty_slot(models, pipeline_depth):
    """Three slots, two streams: the empty slot's row is sampled and not
    kept, the partial window keeps its unpadded frames; counted when the
    round is dispatched, however late its output is handed out."""
    model = models[torch.float32]
    L = model.cfg.n_motions
    bat = _round(model, slots=3, pipeline_depth=pipeline_depth)
    before = counters()
    assert bat.step() == 2
    kept = L + (L - 3)  # 1500 samples short: ceil(1500 / 640) = 3 padded frames
    assert _delta(before) == {"msmd.frames.sampled": 3 * L, "msmd.frames.kept": kept}
    assert sum(len(bat.output(sid)) for sid in ("full", "part")) == kept


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
    # the train step's three parts, each traced step in order, the audio encoder inside the loss
    ranges = _ranges(path)
    parts = [n for n, _, _ in ranges if n.startswith("msmd.train.")]
    assert parts == ["msmd.train.loss", "msmd.train.backward", "msmd.train.optimizer"] * (len(parts) // 3) != []
    losses = [(a, b) for n, a, b in ranges if n == "msmd.train.loss"]
    encoders = [(a, b) for n, a, b in ranges if n == "msmd.audio_encoder"]
    assert encoders and all(any(a0 <= a and b <= b0 for a0, b0 in losses) for a, b in encoders)


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
