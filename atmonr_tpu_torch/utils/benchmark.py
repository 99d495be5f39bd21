"""Timing helpers of the port's bench and tools: the counterpart of the JAX
package's ``utils/benchmark.py``, the same arguments, blocks and stopping
rule.

``warm_until_steady`` runs fixed-size blocks of iterations until two
consecutive blocks' wall times agree within ``tol``; ``timed_window`` times
a run of iterations with one sync at its end. ``fetch`` is the sync: on a
card, ``float`` of a loss copies it to the host, which waits for every
kernel queued before it. (``utils/timing.py`` times single calls on the
device, by CUDA events and graph replay.)
"""

from __future__ import annotations

import sys
import time
from typing import Callable


def warm_until_steady(
    one_iter: Callable[[int], object],
    fetch: Callable[[object], object],
    *,
    start_step: int = 0,
    block: int = 50,
    tol: float = 0.05,
    max_iters: int = 1200,
    on_block: Callable[[int, float], None] | None = None,
) -> int:
    """Run ``one_iter(step)`` in ``block``-sized chunks until the wall time
    of two consecutive chunks agrees within ``tol`` (or ``max_iters`` is
    reached). ``fetch`` must force the returned value (e.g. ``float`` on a
    loss) so the block boundary is a real sync point. ``on_block(n_iters,
    seconds)`` fires after every chunk (the bench emits each block's rate as
    a provisional result). Returns the next step index."""
    step = start_step
    prev = None
    out = None
    while step - start_step < max_iters:
        t0 = time.perf_counter()
        for _ in range(block):
            out = one_iter(step)
            step += 1
        fetch(out)
        dt = time.perf_counter() - t0
        print(
            f"[warmup] block ending at step {step}: {dt:.2f}s"
            f" ({dt / block * 1e3:.1f} ms/iter)",
            file=sys.stderr,
            flush=True,
        )
        if on_block is not None:
            on_block(block, dt)
        if prev is not None and abs(dt - prev) < tol * prev:
            break
        prev = dt
    return step


def timed_window(
    one_iter: Callable[[int], object],
    fetch: Callable[[object], object],
    *,
    start_step: int,
    iters: int,
) -> float:
    """Time ``iters`` iterations (one fetch at the end); returns seconds."""
    out = None
    t0 = time.perf_counter()
    for _ in range(iters):
        out = one_iter(start_step)
        start_step += 1
    fetch(out)
    return time.perf_counter() - t0
