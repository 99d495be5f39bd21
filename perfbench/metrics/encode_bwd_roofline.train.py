"""encode_bwd_roofline.train (%, higher; device trace; layer kernels; moves
setup_s): the least time of every hash-table gradient in the
profiled window (position and surface, each step;
``perfbench/roofline.py``) over the device time of K2 and of the fill that
zeroes its gradient table, the fill kernel launched just before each K2."""

import re

PATTERN = re.compile(r"hash_bwd_")
FILL = re.compile(r"[Ff]ill")


def read(run):
    from perfbench.work import least_encode_seconds

    if run.trace is None or not run.trace.kernels:
        return None
    runs = run.trace.kernel_runs()
    t = 0.0
    for i, (name, s, e) in enumerate(runs):
        if PATTERN.search(name):
            t += e - s
            if i and FILL.search(runs[i - 1][0]):
                t += runs[i - 1][2] - runs[i - 1][1]
    t *= 1e-6
    return 100.0 * least_encode_seconds(run.traced["encode_bwd"], True) / t if t else None
