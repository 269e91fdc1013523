#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cells, configurations, traffic mixes
and metrics are named in BENCHMARK.json and kept in files of their own
under perfbench/ (pb/cell.py says what a run does). Exits non-zero with
no result where there is no card, too few cards, no program to measure,
or a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from pb import cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(cell.main(sys.argv[1:], T_START))
