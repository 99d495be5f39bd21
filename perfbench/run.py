"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json``; see
``perfbench/harness.py``."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:], ROOT, T0))
