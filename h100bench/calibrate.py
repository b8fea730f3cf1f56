"""The readings that a cell's limits are set from, on the card, at the
cell's own size: for each seed of ``--seeds`` a fresh system, a short
window of the cell's traffic (``calibration_units`` of its mode: enough
to finish the mix's longest requests and to compare as many as a run
does) and the comparison of the program against the reference; for each
seed of ``--control`` the same with the control (the reference one
precision below the configuration's) in the program's place. One process
for all seeds; one JSON line a seed.

    python3 h100bench/calibrate.py --workload msmd.offline48 --seeds 1,2,3 --control 4,5,6
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import h100bench  # noqa: E402

h100bench.prepare_env()

import torch  # noqa: E402

from h100bench import harness  # noqa: E402


def readings(cell, mode, seed: int, control: bool) -> dict:
    ctx = harness.Context(cell, seed, 0.0, False, torch.device("cuda", 0), warm=False)
    mode.setup(ctx)
    run = mode.window(ctx, None, min_units=mode.calibration_units(cell))
    out = mode.check(ctx, run, control=control)
    del ctx, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    args = p.parse_args(argv)
    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("h100bench: no card", file=sys.stderr)
        return 2
    mode = harness.mode_of(cell)
    for kind, seeds in (("program", args.seeds), ("control", args.control)):
        for s in (int(x) for x in seeds.split(",") if x):
            t0 = time.perf_counter()
            got = readings(cell, mode, s, kind == "control")
            print(json.dumps({"workload": cell.name, "kind": kind, "seed": s, "readings": got,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
