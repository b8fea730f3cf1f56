"""Run one cell of the benchmark once; see ``h100bench/harness.py``.

    python3 h100bench/run.py --workload msmd.offline48 --seed 7 --seconds 45 --trace 0
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import h100bench  # noqa: E402

h100bench.prepare_env()

from h100bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
