"""What the per-layer metric readers (``metrics/<name>.py``) share. A
reader returns None where its run has nothing to read, and the harness
then leaves the metric out of the line: never 0 for a share."""

from __future__ import annotations

import re
from typing import Optional

from h100bench import work


def idle_pct(run) -> Optional[float]:
    """The share of the traced window in which no device operation ran."""
    t = run.tracer
    if t is None or not t.sessions or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s


def mfu(run) -> Optional[float]:
    """The model's operations of the traced units over the traced window's
    length times the bf16 peak."""
    t, flops = run.tracer, run.work.get("traced_flops", 0)
    if t is None or not t.sessions or not flops:
        return None
    return 100.0 * flops / t.window_s / work.BF16_PEAK


def roofline(run, pattern: re.Pattern, calls: str, bound_s: float) -> Optional[float]:
    """A kernel's bound a call over its device time a call in the trace:
    the device time of the kernels whose names match ``pattern`` over the
    calls the traced units made (``run.work[calls]``)."""
    t, n = run.tracer, run.work.get(calls, 0)
    if t is None or not n:
        return None
    device_s = t.kernel_s(pattern)
    if device_s <= 0:
        return None
    return 100.0 * bound_s / (device_s / n)
