"""On the card (``cuda`` marker; skips without one): every cell of
``BENCHMARK.json`` runs once, short, traced and untraced, and prints a
result line that is correct and carries the cell's metrics.

    python3 -m pytest -p no:cacheprovider -q -m cuda h100bench/tests/test_h100bench_cuda.py
"""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from h100bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_of_each_cell_is_correct(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels have no CPU mode here")
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", cell, "--seed", str(2 ** 32 + 17),
                          "--seconds", "5", "--trace", str(trace)], capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    c = harness.Cell.load(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= want and (trace or set(line["metrics"]) == want)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
