"""Device traces of a run's units (``--trace 1``).

Each traced unit runs in a torch.profiler session of its own (CPU and
CUDA activity) that starts on an idle card, holds 5 ms of idle host time
inside each end, and ends after a synchronize. The traced window is the
benchmark's own ``bench.unit`` span; the device is busy where a kernel,
copy or fill ran inside it. On the H100 machines a session now and then
keeps its launch calls and loses its kernel records: a session with
fewer kernel records than launch calls is not counted, and the next unit
is traced instead (``lost``).

Idle time is named by the innermost ``bench.*`` span the host was in
when the gap began: the benchmark's spans around its calls into the
program.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

PAD_S = 0.005
LAUNCH = re.compile(r"^cudaLaunch(Cooperative)?Kernel")
UNIT = "bench.unit"


span = torch.profiler.record_function  # a benchmark span: a profiler record, free when no session is on


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def session_stats(kernels, others, spans, unit: Tuple[float, float]) -> dict:
    """One session's readings from its device records and the host spans,
    all in microseconds: ``kernels`` [(name, start, end)] (kernel
    launches), ``others`` [(name, start, end)] (copies and fills),
    ``spans`` [(name, start, end)] (the ``bench.*`` spans), ``unit`` the
    traced window. Returns window, busy, time by device operation and
    idle by span, in seconds."""
    u0, u1 = unit
    clip = [(max(a, u0), min(b, u1)) for _, a, b in kernels + others if b > u0 and a < u1]
    busy = merge(clip)
    by_op: Dict[str, float] = defaultdict(float)
    for name, a, b in kernels + others:
        by_op[name] += (b - a) * 1e-6
    gaps, at = [], u0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < u1:
        gaps.append((at, u1))
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        inside = [s for s in spans if s[1] <= g0 < s[2] and s[0] != UNIT]
        label = max(inside, key=lambda s: s[1])[0] if inside else "bench.outside_spans"
        idle[label] += (g1 - g0) * 1e-6
    return dict(window_s=(u1 - u0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6, ops=dict(by_op),
                idle=dict(idle))


def _name_key(name: str) -> str:
    """A kernel's name without its argument list (the last parenthesised
    group; ``(anonymous namespace)::`` and template arguments stay)."""
    name = name.strip()
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].strip() or name
    return name


def _ns(e, end: bool = False) -> float:
    """An event's start or end in microseconds."""
    if hasattr(e, "start_ns"):
        return (e.end_ns() if end else e.start_ns()) * 1e-3
    return e.start_us() + (e.duration_us() if end else 0)


class Tracer:
    """Traces units one session each and sums their readings."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.ops: Dict[str, float] = defaultdict(float)
        self.idle: Dict[str, float] = defaultdict(float)
        self.sessions = 0
        self.lost = 0

    def run(self, fn: Callable[[], object]) -> Tuple[object, Optional[dict]]:
        """``fn()`` in a session; returns (its result, the session's
        readings or None when the session lost its kernel records)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            with span(UNIT):
                out = fn()
                torch.cuda.synchronize()
            time.sleep(PAD_S)
        kernels, others, spans, launches = [], [], [], 0
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith("bench.") or getattr(e, "is_user_annotation", lambda: False)():
                    continue  # the benchmark's spans as the device timeline shows them
                low = name.lower()
                (others if ("memcpy" in low or "memset" in low) else kernels).append(
                    (_name_key(name), _ns(e), _ns(e, True)))
            elif LAUNCH.match(name):
                launches += 1
            elif name.startswith("bench."):
                spans.append((name, _ns(e), _ns(e, True)))
        units = [s for s in spans if s[0] == UNIT]
        if len(kernels) < launches or not units:
            self.lost += 1
            return out, None
        st = session_stats(kernels, others, spans, units[0][1:])
        self.sessions += 1
        self.window_s += st["window_s"]
        self.busy_s += st["busy_s"]
        for k, v in st["ops"].items():
            self.ops[k] += v
        for k, v in st["idle"].items():
            self.idle[k] += v
        return out, st

    def kernel_s(self, pattern: re.Pattern) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        return sum(v for k, v in self.ops.items() if pattern.search(k))

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.ops), "idle_gaps": top(self.idle)}
