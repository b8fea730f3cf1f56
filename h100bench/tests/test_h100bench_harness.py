"""The harness on the CPU: cells, configurations, traffic mixes, limits
and metric readers found by name; ``BENCHMARK.json`` within the
contract's limits; the import check; the traffic's draws from a seed;
the metric arithmetic (a rate over the whole window, a percentile over
every request, an idle share from kernel intervals, roofline and mfu
from counts)."""

import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import ROOT, tiny_cell
from h100bench import harness, readers, system as sysm, trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name_with_its_metric_readers(cell):
    c = harness.Cell.load(cell)
    assert c.chips == 1
    mode = harness.mode_of(c)
    for fn in ("setup", "window", "check", "calibration_units"):
        assert callable(getattr(mode, fn))
    assert mode.calibration_units(c) >= 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_file_module(harness.HERE / "metrics" / f"{m['name']}.py").read)
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_a_missing_piece_is_named():
    with pytest.raises(harness.RunError, match="no cell"):
        harness.Cell.load("msmd.nothing")
    with pytest.raises(harness.RunError, match="missing"):
        harness.load_file_module(harness.HERE / "metrics" / "nothing.py")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"] and BENCH["command"][1].startswith("h100bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("h100bench/")
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:  # each cell a per-layer metric names reports what it moves
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_the_import_check_compares_whole_top_level_names():
    mods = {"msmd_tpu_torch": 1, "msmd_tpu_torch.models": 1, "jaxtyping": 1, "flaxen.x": 1}
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules({**mods, "jax.numpy": 1, "msmd_tpu.ops": 1, "flax": 1}) == [
        "flax", "jax.numpy", "msmd_tpu.ops"]


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); import h100bench; h100bench.prepare_env(); "
            "from h100bench import harness, checks, system, trace; "
            "from h100bench.modes import offline, live, stream; import msmd_tpu_torch.serving, "
            "msmd_tpu_torch.inference_lib; print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "msmd.live1", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_offline_clip_plan_is_the_mix_cycled_in_its_order_for_every_seed():
    """Every seed does the same work: the plan takes no seed, and two
    tiny cells of different seeds call the same lengths."""
    from h100bench.modes import offline

    assert offline.clip_plan([6.5, 10.5, 14.5], 7) == [6.5, 10.5, 14.5, 6.5, 10.5, 14.5, 6.5]
    plans = []
    for seed in (2 ** 33 + 7, 5):
        ctx = harness.Context(tiny_cell("offline"), seed, 0.0, False, harness.torch.device("cpu"))
        offline.setup(ctx)
        plans.append(ctx.state["plan"][:8])
    assert plans[0] == plans[1] == [0.5, 0.9] * 4


def test_seeds_beyond_32_bits_give_distinct_streams():
    s = [sysm.sub_seed(2 ** 31 + 1, 40, c, 0) for c in range(96)]
    assert len(set(s)) == 96 and all(0 <= x < 2 ** 63 for x in s)
    assert sysm.sub_seed(5, -1) == sysm.sub_seed(5, 2 ** 64 - 1)


def test_weights_come_from_the_seed_in_their_scales():
    shapes = {"a.weight": (64, 32), "a.bias": (64,), "n.weight": (32,), "pe": (1, 8, 32)}
    g = lambda s: sysm.generator("cpu", s, 1)
    w1, w2, w3 = (sysm.seeded_weights(shapes, "cpu", g(s)) for s in (3, 3, 4))
    assert all(np.array_equal(w1[k], w2[k]) for k in shapes) and not np.array_equal(w1["pe"], w3["pe"])
    assert abs(float(w1["a.weight"].std()) - 32 ** -0.5) < 0.02
    assert abs(float(w1["n.weight"].mean()) - 1.0) < 0.05 and float(w1["a.bias"].std()) < 0.2


def test_percentile_interpolates_over_every_request():
    assert harness.percentile(range(1, 101), 90) == pytest.approx(90.1)
    assert harness.percentile([5.0], 90) == 5.0


def test_session_stats_from_synthetic_intervals():
    """Two kernels overlapping, a copy, an idle gap inside a span."""
    kernels = [("k1", 10, 40), ("k1", 30, 50), ("k2", 70, 80)]
    others = [("Memcpy DtoH", 80, 90)]
    spans = [("bench.unit", 0, 100), ("bench.infer_coeffs", 0, 60), ("bench.vertex_copy", 60, 100)]
    st = trace.session_stats(kernels, others, spans, (0, 100))
    assert st["window_s"] == pytest.approx(100e-6) and st["busy_s"] == pytest.approx(60e-6)
    assert st["ops"] == pytest.approx({"k1": 50e-6, "k2": 10e-6, "Memcpy DtoH": 10e-6})
    assert st["idle"] == pytest.approx({"bench.infer_coeffs": 30e-6, "bench.vertex_copy": 10e-6})


def fake_run(window_s, busy_s, ops, **work_counts):
    t = trace.Tracer()
    t.window_s, t.busy_s, t.sessions = window_s, busy_s, 1
    t.ops.update(ops)
    return SimpleNamespace(tracer=t, work=work_counts)


def test_idle_mfu_and_roofline_from_counts():
    run = fake_run(2.0, 1.5, {"void gemm_sm90_kernel<2>": 1.0, "ln_kernel<true>": 0.5, "scan_kernel": 0.2},
                   traced_flops=989e12 * 0.25, k1_calls=1000)
    assert readers.idle_pct(run) == pytest.approx(25.0)
    assert readers.mfu(run) == pytest.approx(12.5)
    k1 = re.compile(r"\b(gemm_sm90_kernel|ln_kernel)\b")
    assert readers.roofline(run, k1, "k1_calls", 0.75e-3) == pytest.approx(50.0)
    assert readers.roofline(run, re.compile(r"\bnone_kernel\b"), "k1_calls", 1e-3) is None
    assert readers.roofline(run, k1, "k3_calls", 1e-3) is None
    assert readers.mfu(SimpleNamespace(tracer=trace.Tracer(), work={})) is None
    assert readers.idle_pct(SimpleNamespace(tracer=None, work={})) is None


def test_rates_count_all_the_work_over_all_the_window():
    """Offline and streaming rates over a tiny cell's whole window."""
    from conftest import cpu_run

    ctx, run, _ = cpu_run("offline")
    assert run.attempted == 1 and run.e2e["audio_rate"] > 0
    ctx, run, _ = cpu_run("stream")
    assert run.attempted == 6 * 4  # 6 rounds (3 windows a stream, 6 clients over 4 slots), every round full
    assert run.e2e["audio_rate"] > 0


def test_the_window_ends_with_the_seconds_and_counts_every_request():
    from h100bench.modes import live

    ctx = harness.Context(tiny_cell("live"), 77, 0.5, False, harness.torch.device("cpu"))
    live.setup(ctx)
    t0 = time.perf_counter()
    run = live.window(ctx, None)
    elapsed = time.perf_counter() - t0
    lat = run.work["latencies_ms"]
    assert run.attempted == len(lat) >= 2
    # closed loop: each request is sent when the last one is done, and none starts after the window
    assert sum(lat) <= elapsed * 1e3 and sum(lat[:-1]) < 500.0 <= elapsed * 1e3
    assert run.e2e["utterance_p90_ms"] == pytest.approx(harness.percentile(lat, 90))
