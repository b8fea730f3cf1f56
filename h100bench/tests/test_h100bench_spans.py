"""``spans.py`` on synthetic profiler events: a program span's footprint
follows the correlation ids to launches on any thread and nests
inclusively, the self parts and what no span holds add up to the window,
and a session that holds ``msmd.*`` ranges (host ranges and their
device-side annotation records) gives ``Tracer``'s readings equal to the
same session without them. The counter metric reads the program's
counters and nothing where the program keeps none."""

import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from h100bench import harness, spans, trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def event(name, dev, start, end, corr=0, annotation=False):
    """A Kineto record: times in microseconds."""
    return SimpleNamespace(name=lambda: name, device_type=lambda: dev, start_ns=lambda: start * 1000,
                           end_ns=lambda: end * 1000, correlation_id=lambda: corr,
                           is_user_annotation=lambda: annotation)


# a unit of 200 us: the outer span holds the inner one; kernel 1 launched
# in the inner span, kernel 2 launched from another thread while only the
# outer span is open, a copy launched outside both
BASE = [event("bench.unit", CPU, 0, 200), event("bench.infer_coeffs", CPU, 0, 150),
        event("cudaLaunchKernel", CPU, 15, 16, corr=101), event("k_a", CUDA, 20, 30, corr=101),
        event("cudaLaunchKernelExC", CPU, 50, 52, corr=102), event("k_b", CUDA, 55, 70, corr=102),
        event("cudaMemcpyAsync", CPU, 120, 121, corr=103), event("Memcpy DtoH", CUDA, 125, 130, corr=103),
        event("aten::mm", CPU, 14, 17, corr=101)]  # a torch op: its id is of another series
PROGRAM = [event("msmd.outer", CPU, 0, 100), event("msmd.inner", CPU, 10, 40),
           event("msmd.outer", CUDA, 20, 70, corr=1, annotation=True),
           event("msmd.inner", CUDA, 20, 30, corr=2, annotation=True)]


@pytest.fixture
def fake_sessions(monkeypatch):
    """torch.profiler.profile replaced by sessions whose events are given,
    in turn; no card needed."""
    queue = []

    class Session:
        def __init__(self, activities):
            self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda ev=queue.pop(0): ev))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace, "PAD_S", 0.0)
    return queue


def test_footprints_follow_correlation_ids_and_nest_inclusively():
    sp = [("msmd.outer", 0, 100), ("msmd.inner", 10, 40)]
    records = [(101, 20, 30), (102, 55, 70), (103, 125, 130)]
    incl, own, idle = spans.footprints(sp, records, {101: 15, 102: 50, 103: 120}, (0, 200))
    # gaps: 0-20, 30-55, 70-125, 130-200; each goes to the spans open where it begins
    assert incl == pytest.approx({"msmd.inner": 35e-6, "msmd.outer": 125e-6})
    assert own == pytest.approx({"msmd.inner": 35e-6, "msmd.outer": 90e-6, spans.NO_SPAN: 75e-6})
    assert idle == pytest.approx({"msmd.inner": 25e-6, "msmd.outer": 100e-6})
    assert sum(own.values()) == pytest.approx(200e-6)
    # a record whose launch the session did not see belongs to no span
    _, own, _ = spans.footprints(sp, [(999, 20, 30)], {}, (0, 200))
    assert own == pytest.approx({"msmd.outer": 20e-6, spans.NO_SPAN: 10e-6, "msmd.inner": 170e-6})


def test_a_session_with_program_spans_reads_as_one_without(fake_sessions):
    plain, with_spans = trace.Tracer(), spans.SpanTracer()
    fake_sessions += [BASE, BASE + PROGRAM]
    _, st0 = plain.run(lambda: None)
    _, st1 = with_spans.run(lambda: None)
    assert st0 == st1 and st0["busy_s"] == pytest.approx(30e-6)
    for key in ("window_s", "busy_s", "ops", "idle", "sessions", "lost"):
        assert getattr(plain, key) == getattr(with_spans, key)
    assert plain.breakdown() == with_spans.breakdown()
    assert not any(k.startswith("msmd.") for k in plain.ops)
    assert dict(with_spans.footprint) == pytest.approx({"msmd.inner": 35e-6, "msmd.outer": 125e-6})
    assert with_spans.n_spans == 2 and torch.profiler.profile.__name__ == "Session"
    assert with_spans.summary()["overlap_ms"] == pytest.approx(0.0)  # no two records overlap


def test_a_session_that_lost_its_kernels_adds_no_footprint(fake_sessions):
    t = spans.SpanTracer()
    fake_sessions += [[e for e in BASE + PROGRAM if e.device_type() == CPU]]
    _, st = t.run(lambda: None)
    assert st is None and t.lost == 1 and not t.footprint and not t.counted


def test_the_counter_metric_reads_the_programs_counters(monkeypatch):
    from msmd_tpu_torch.utils import profiling

    reader = harness.load_file_module(harness.HERE / "metrics" / "useful_frames_pct.audio_rate.py")
    monkeypatch.setattr(profiling, "_COUNTS", {})
    assert reader.read(None, None) is None
    profiling.count("msmd.frames.sampled", 200)
    profiling.count("msmd.frames.kept", 162)
    assert reader.read(None, None) == pytest.approx(81.0)
    monkeypatch.setitem(sys.modules, "msmd_tpu_torch.utils.profiling", None)  # a program without counters
    assert reader.read(None, None) is None
