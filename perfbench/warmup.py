"""The warm-up rule (a frozen copy of the port's ``utils/benchmark.py``
``warm_until_steady``): blocks of iterations, each ended by a fetch that
waits for the device, until two consecutive blocks' wall times agree
within ``tol`` or ``max_iters`` have run."""

from __future__ import annotations

import sys
import time
from typing import Callable


def warm_until_steady(one_iter: Callable[[], object], fetch: Callable[[object], object], *,
                      block: int, tol: float = 0.05, max_iters: int = 1200) -> int:
    """Runs ``one_iter()`` in blocks; returns the iterations run."""
    done, prev, out = 0, None, None
    while done < max_iters:
        t0 = time.perf_counter()
        for _ in range(block):
            out = one_iter()
        done += block
        fetch(out)
        dt = time.perf_counter() - t0
        print(f"[warmup] {done} iterations: block {dt:.3f}s", file=sys.stderr, flush=True)
        if prev is not None and abs(dt - prev) < tol * prev:
            break
        prev = dt
    return done
