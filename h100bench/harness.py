"""One run of one cell: ``python3 h100bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<traffic>.json`` (whose ``mode`` names the
code that drives it, ``modes/<mode>.py``), the limits of its comparison in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. A run builds the system from the seed, warms up
the cell's shapes (set-up), drives the traffic for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line as the last line of standard output.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "msmd_tpu")


class RunError(Exception):
    """A run that prints no result."""


def load_file_module(path: Path):
    """A module from a file path (names may hold dots)."""
    if not path.is_file():
        raise RunError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"h100bench_{path.parent.name}_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise RunError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``msmd_tpu_torch`` passes."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


@dataclass
class Cell:
    """A cell and what it is made of."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def load(cls, name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> "Cell":
        bench = read_json(bench_path)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise RunError(f"no cell {name!r} in BENCHMARK.json")
        w = cells[name]
        e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return cls(name, w["chips"], read_json(HERE / "configs" / f"{w['config']}.json"),
                   read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                   read_json(HERE / "limits" / f"{name}.json"), e2e, per_layer)


@dataclass
class Run:
    """What a mode's window did: requests attempted and failed, the
    end-to-end readings by metric name, the counts that per-layer readers
    read (``work``) and the trace."""

    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, float] = field(default_factory=dict)
    tracer: Optional[object] = None


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    dev: torch.device
    warm: bool = True  # set-up warms up the cell's shapes (not for the readings of a limit)
    system: object = None
    state: dict = field(default_factory=dict)  # a mode's inputs and objects


def mode_of(cell: Cell):
    return load_file_module(HERE / "modes" / f"{cell.traffic['mode']}.py")


def note(text: str) -> None:
    print(f"h100bench: {text}", file=sys.stderr, flush=True)


def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def pinned(shape, dev) -> torch.Tensor:
    """A host buffer that the card copies into without staging."""
    return torch.empty(shape, pin_memory=torch.device(dev).type == "cuda")


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        raise RunError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def device_info(chips: int, dev) -> dict:
    if torch.device(dev).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def checks_line(checks: Dict[str, float], limits: dict) -> Dict[str, dict]:
    missing = sorted(set(checks) - set(limits))
    if missing:
        raise RunError(f"no limit for {missing} in limits/<cell>.json")
    return {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}


def run(args, t_start: float) -> dict:
    cell = Cell.load(args.workload)
    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is false: this benchmark runs on an NVIDIA card")
    if torch.cuda.device_count() < cell.chips:
        raise RunError(f"the cell asks for {cell.chips} cards, {torch.cuda.device_count()} are visible")
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, dev, t_start: float) -> dict:
    """Everything of a run after the look for the card: set-up, the
    window, the check, the metrics and the import check; the result line
    as a dict."""
    mode = mode_of(cell)
    ctx = Context(cell, seed, seconds, traced, dev)
    mode.setup(ctx)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    note(f"set-up {setup_s:.3f} s")
    tracer = None
    if traced:
        from h100bench.trace import Tracer

        tracer = Tracer()
    t0 = time.perf_counter()
    result = mode.window(ctx, tracer, min_units=mode.calibration_units(cell))
    sync(dev)
    note(f"window {time.perf_counter() - t0:.3f} s, {result.attempted} attempted")
    device = device_info(cell.chips, dev)
    t0 = time.perf_counter()
    checks = mode.check(ctx, result)
    note(f"reference {time.perf_counter() - t0:.3f} s")
    metrics = {}
    if traced:
        if tracer.sessions == 0:
            raise RunError(f"every profiler session lost its kernel records ({tracer.lost})")
        for m in cell.per_layer:
            value = load_file_module(HERE / "metrics" / f"{m['name']}.py").read(ctx, result)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=tracer.busy_s, window_s=tracer.window_s)
        note(f"{tracer.sessions} profiler sessions kept, {tracer.lost} lost")
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else result.e2e.get(m["name"])
            if value is None:
                raise RunError(f"the mode gave no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        raise RunError("modules of the JAX package or of JAX are loaded: " + ", ".join(bad))
    line = checks_line(checks, cell.limits)
    correct = result.attempted > 0 and result.failed == 0 and all(c["value"] <= c["limit"] for c in line.values())
    out = {"correct": correct, "attempted": result.attempted, "failed": result.failed, "metrics": metrics,
           "device": device}
    if traced:
        out["breakdown"] = tracer.breakdown()
    out["checks"] = line
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        out = run(args, t_start)
    except RunError as e:
        print(f"h100bench: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
