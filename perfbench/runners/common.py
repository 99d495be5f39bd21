"""What the runners share: the clock, device synchronisation, the
program's launch counters, host snapshots whose time set-up leaves out, and
the worst-leaf norm gap of the training comparison."""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Seconds since ``t0`` with time spent in ``excluded()`` blocks taken out
    (copies the comparison needs, which are not the program's set-up)."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.skipped = 0.0

    def now(self) -> float:
        return time.perf_counter() - self.t0 - self.skipped

    class _Excluded:
        def __init__(self, clock):
            self.clock = clock

        def __enter__(self):
            self.t = time.perf_counter()

        def __exit__(self, *exc):
            self.clock.skipped += time.perf_counter() - self.t

    def excluded(self):
        return Clock._Excluded(self)


def launch_counters() -> dict:
    """The port's kernel launch counters: K1, K1p and K2."""
    from atmonr_tpu_torch.ops.hash_bwd import hash_bwd
    from atmonr_tpu_torch.ops.hash_gather import hash_gather, quantize_tables

    return {"hash_gather": sum(hash_gather.launches.values()),
            "quantize_tables": sum(quantize_tables.launches.values()),
            "hash_bwd": sum(hash_bwd.launches.values())}


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def free_device_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def worst_leaf_gap(program: dict, reference: dict, leaves) -> float:
    """max over ``leaves`` of |program norm - reference norm| over the larger
    of that leaf's reference norm and the median leaf's."""
    med = float(np.median([reference[k] for k in leaves]))
    return max(abs(program[k] - reference[k]) / max(reference[k], med) for k in leaves)


def finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf
