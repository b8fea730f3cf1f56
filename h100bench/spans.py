"""The program's own spans in traced units: each ``msmd.*`` span's
footprint on the device.

The port opens a ``record_function`` range at each layer boundary while a
profiler session is on (``msmd_tpu_torch/utils/profiling.py``: the audio
encoder, the sampler's set-up and steps, the FLAME decode, the batcher's
phases, the train step's three parts) and counts the frames it samples
and keeps. ``SpanTracer`` is ``trace.Tracer`` that also keeps, for each
session it keeps, those ranges and the counters' change over the session.

A span's footprint is the device time of the kernels, copies and fills
whose runtime call (the CPU record of the device record's correlation
id, on any thread: autograd's backward launches from a thread of its
own) began while the span was open, plus the device's idle gaps that
began while it was open. It is inclusive: a span counts what the spans
inside it count. The self part gives each record and gap to the
innermost open span alone, or to no span; the self parts and what no
span holds add up to the traced window wherever no two device records
overlap.

``Tracer``'s readings (window, busy, time by device operation, idle by
benchmark span, the lost-session rule) come from ``Tracer.run`` itself:
the session it opens is kept and read once more here.

    python3 h100bench/spans.py --workload msmd.live1 --seed 5000000001

runs a cell's set-up and its traced units (its traffic's
``trace_units``; stream48 then rounds untraced to its calibration
count) and prints one JSON line: the tracer's readings and each span's
footprint, self part and idle part a unit, what no span holds, the
counters' change, the share of the window the self parts account for
(above 100 by the device time that ran beside other device time:
``overlap_ms``), and what a span costs on this host with no session and
inside one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import h100bench

    h100bench.prepare_env()

import torch  # noqa: E402

from h100bench.trace import Tracer, merge  # noqa: E402

PROGRAM = "msmd."
NO_SPAN = "no_program_span"


def idle_gaps(records: List[Tuple[float, float]], unit: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The stretches of ``unit`` with no device record running, as
    ``trace.session_stats`` finds them."""
    u0, u1 = unit
    gaps, at = [], u0
    for a, b in merge([(max(a, u0), min(b, u1)) for a, b in records if b > u0 and a < u1]):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < u1:
        gaps.append((at, u1))
    return gaps


def footprints(spans, records, launches: Dict[int, float], unit) -> Tuple[dict, dict, dict]:
    """``spans`` [(name, start, end)] the program's ranges; ``records``
    [(correlation id, start, end)] the device's kernels, copies and
    fills; ``launches`` {correlation id: start} the runtime calls; ``unit``
    the traced window; all in microseconds. Returns, in seconds by span
    name, the footprint, the self part (with ``NO_SPAN``) and the idle
    part of the footprint."""
    u0, u1 = unit
    incl, own, idle = defaultdict(float), defaultdict(float), defaultdict(float)
    items = [(launches.get(c), max(a, u0), min(b, u1), False) for c, a, b in records if b > u0 and a < u1]
    items += [(a, a, b, True) for a, b in idle_gaps([(a, b) for _, a, b in records], unit)]
    for t, a, b, gap in items:
        d = (b - a) * 1e-6
        inside = [s for s in spans if t is not None and s[1] <= t < s[2]]
        for name in {s[0] for s in inside}:
            incl[name] += d
            if gap:
                idle[name] += d
        own[max(inside, key=lambda s: s[1])[0] if inside else NO_SPAN] += d
    return dict(incl), dict(own), dict(idle)


def session_spans(prof) -> Tuple[list, list, dict, tuple]:
    """A finished session's program ranges, device records (the ones
    ``Tracer`` counts: no benchmark or program annotation), runtime calls
    by correlation id, and the benchmark's unit span."""
    from torch.autograd import DeviceType

    from h100bench.trace import UNIT, _ns

    spans, records, launches, unit = [], [], {}, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not (name.startswith(("bench.", PROGRAM)) or getattr(e, "is_user_annotation", lambda: False)()):
                records.append((e.correlation_id(), _ns(e), _ns(e, True)))
        elif name.startswith(PROGRAM):
            spans.append((name, _ns(e), _ns(e, True)))
        elif name.startswith("cu"):  # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...: a CUDA API call
            launches[e.correlation_id()] = _ns(e)
        elif name == UNIT:
            unit = (_ns(e), _ns(e, True))
    return spans, records, launches, unit


class SpanTracer(Tracer):
    """``Tracer`` with each kept session's program spans and counters."""

    def __init__(self):
        super().__init__()
        self.footprint: Dict[str, float] = defaultdict(float)
        self.own: Dict[str, float] = defaultdict(float)
        self.idle_in: Dict[str, float] = defaultdict(float)
        self.counted: Dict[str, int] = defaultdict(int)
        self.n_spans = 0

    def run(self, fn):
        from msmd_tpu_torch.utils.profiling import counters

        kept, base = [], torch.profiler.profile

        class Kept(base):  # the session Tracer.run opens, kept when it closes
            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                kept.append(self)
                return out

        before = counters()
        torch.profiler.profile = Kept
        try:
            out, st = super().run(fn)
        finally:
            torch.profiler.profile = base
        if st is not None:
            spans, records, launches, unit = session_spans(kept[-1])
            incl, own, idle = footprints(spans, records, launches, unit)
            for total, part in ((self.footprint, incl), (self.own, own), (self.idle_in, idle)):
                for k, v in part.items():
                    total[k] += v
            after = counters()
            for k, v in after.items():
                self.counted[k] += v - before.get(k, 0)
            self.n_spans += len(spans)
        return out, st

    def summary(self) -> dict:
        """Readings a unit (a kept session), in ms where they are times."""
        n = max(self.sessions, 1)
        per = lambda d: {k: v * 1e3 / n for k, v in sorted(d.items())}
        sampled = self.counted.get("msmd.frames.sampled", 0)
        held = sum(self.own.values())  # the window, plus the time device records ran beside others
        return dict(sessions=self.sessions, lost=self.lost, window_ms=self.window_s * 1e3 / n,
                    busy_ms=self.busy_s * 1e3 / n, overlap_ms=(held - self.window_s) * 1e3 / n,
                    idle_by_bench_span_ms=per(self.idle),
                    footprint_ms=per(self.footprint), self_ms=per(self.own), idle_in_span_ms=per(self.idle_in),
                    accounted_pct=100.0 * held / self.window_s if self.window_s else None,
                    spans_per_unit=self.n_spans / n, counted=dict(self.counted),
                    useful_frames_pct=100.0 * self.counted.get("msmd.frames.kept", 0) / sampled if sampled else None,
                    breakdown=self.breakdown())


def span_cost(n: int = 100000) -> dict:
    """Microseconds a span costs on this host, less an empty loop's turn:
    the program's ``span`` with no session on and inside a session, and a
    bare ``record_function`` with no session on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from msmd_tpu_torch.utils.profiling import span

    def per(make, k):
        t = time.perf_counter()
        for _ in range(k):
            with make("msmd.cost"):
                pass
        spent = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(k):
            pass
        return (spent - (time.perf_counter() - t)) / k * 1e6

    out = dict(span_us_off=per(span, n), record_function_us_off=per(record_function, n))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["span_us_on"] = per(span, n // 10)
    return out


def main(argv=None) -> int:
    from h100bench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    cell = harness.Cell.load(args.workload)
    dev = torch.device("cuda", 0)
    mode = harness.mode_of(cell)
    seconds = json.loads((harness.ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    ctx = harness.Context(cell, args.seed, seconds, True, dev)
    mode.setup(ctx)
    harness.sync(dev)
    cost = span_cost()
    tracer = SpanTracer()
    mode.window(ctx, tracer, min_units=mode.calibration_units(cell))
    harness.sync(dev)
    print(json.dumps(dict(workload=cell.name, seed=args.seed, device=torch.cuda.get_device_name(0),
                          **tracer.summary(), **cost)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
