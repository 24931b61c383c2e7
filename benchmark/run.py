"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout; `BENCHMARK.json` names the cells. Needs
CUDA: without it, or with fewer cards than the cell asks for, it prints
no result and exits 2.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process on one core with one compute thread a library: frames and
# steps are host-bound, and a thread pool or a move between cores shows
# up as spread between runs. Set before torch or numpy load.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
if hasattr(os, "sched_setaffinity"):
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
