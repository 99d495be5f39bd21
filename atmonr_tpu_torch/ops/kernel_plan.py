"""How the two hash-grid kernels take the levels of a grid: the level plan.

Both CUDA kernels (``csrc/hash_gather.cu``, K1, and ``csrc/hash_bwd.cu``, K2)
can run blocks that work on one level each (K1: one group of 4 levels) and
keep that level's slice of the table in shared memory: K1 the table rows in
their storage type, K2 float32 accumulators of 8 bytes a row. ``level_plan``
decides which of two ways a launch takes its levels, and nothing else does:

- ``"staged"``: every level's slice (K1: every group's slices together) fits
  a block's shared memory (K2: half of it), and the launch has points enough
  for as many blocks as the card has SMs.
- ``"direct"``: a slice is too large, or the launch has too few points for
  staging to pay (a staged block loads or zeroes, and K2 flushes, its whole
  slice whatever the number of points). Per-corner gathers from, or atomic
  adds to, global memory.

A launch is staged whole or not at all. Two finer plans were measured on an
H100 and lost to the direct path at every shape, so neither is here: a level
too large for a block cut into row ranges (each range's blocks repeat the
level's index math), and the few coarse levels that fit staged beside a
direct grid for the rest. ``PERF.md`` (Findings) holds those numbers.

The plan is a function of the grid config, the number of points and the
bytes of a row alone. The thresholds are the constants below; ``PERF.md``
holds the measurement that set each one (``scripts/bench_kernels.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from atmonr_tpu_torch.models.hash_grid import HashGridConfig

MAX_LEVELS = 32  # kMaxLevels in csrc/hash_common.cuh
# dynamic shared memory a block of an H100 may use (227 KB; the staged
# kernels hold no static shared memory)
SHARED_BUDGET = 232_448
MAX_GRID = 2**31 - 1
# staged blocks aimed at: the card's 132 SMs twice over
TARGET_BLOCKS = 2 * 132
# fewer staged blocks than the card has SMs leave most of it idle while each
# block loads, or zeroes and flushes, whole slices: then the launch is direct
MIN_STAGED_BLOCKS = 132
DIRECT_THREADS = 256  # kDirectThreads

# K1 (csrc/hash_gather.cu): a staged block takes GROUP_LEVELS consecutive
# levels, one 32-byte sector of an output row.
GROUP_LEVELS = 4  # kGroupLevels
GATHER_THREADS = 1024  # kGatherThreads
# a staged block's chunk of points gathers at least this many rows for each
# 16-byte load of its slices' copy
GATHERS_PER_LOAD = 8

# K2 (csrc/hash_bwd.cu): a thread walks up to RUN_POINTS consecutive points.
RUN_POINTS = 8  # kRunPoints
STAGED_THREADS = 512  # kStagedThreads
# a staged block's accumulators leave room for a second block on its SM: one
# block of 512 threads to an SM (2^14-entry levels, 128 KB) adds slower than
# the direct path
SCATTER_BUDGET = SHARED_BUDGET // 2
# a staged block's chunk of points adds at least this many corners per row
# of the largest slice, so that zeroing and flushing a slice (up to one
# global atomic a row) stay a small share of a block's work
CHUNK_ADDS_PER_ROW = 8
# direct threads aimed at: a thread's run of points is halved until the
# launch has this many threads (the card holds 132 x 2,048)
MIN_DIRECT_THREADS = 132 * 2048


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class LevelPlan:
    """How one launch takes the levels of a grid.

    ``ways[l]`` is ``"staged"`` or ``"direct"``, the same for every level.

    Staged: ``blocks`` blocks of ``threads`` threads with ``shared_bytes`` of
    dynamic shared memory, one per (level, chunk of ``chunk_points`` points)
    for K2 (``scatter``) and one per (group of 4 consecutive levels, chunk)
    for K1. The level or group is the fast index, so that the blocks of one
    chunk of points run close together and share its positions (K2: and
    cotangents) in the L2 cache.

    Direct: ``blocks`` blocks of 256 threads, one thread per (point, level)
    for K1 and per (``run_points`` consecutive points, level) for K2."""

    scatter: bool
    ways: tuple[str, ...]
    threads: int
    chunk_points: int  # staged: of a block's chunk; else 0
    n_chunks: int
    shared_bytes: int  # dynamic shared memory of a staged block; else 0
    blocks: int
    run_points: int = 1  # K2, direct: points of a thread's run

    @property
    def staged(self) -> bool:
        return "staged" in self.ways

    def describe(self) -> str:
        """One line for a log: the levels by way, the shared memory and the
        blocks of the launch."""
        if self.staged:
            return (f"levels: {len(self.ways)} staged; {self.blocks} blocks of {self.threads} "
                    f"threads with {self.shared_bytes} bytes of shared memory "
                    f"({self.n_chunks} chunks of {self.chunk_points} points)")
        runs = f", runs of {self.run_points} points" if self.scatter else ""
        return (f"levels: {len(self.ways)} direct; {self.blocks} blocks of {self.threads} "
                f"threads{runs}")


@functools.cache
def level_plan(cfg: HashGridConfig, m: int, row_bytes: int, scatter: bool) -> LevelPlan:
    """The plan of one launch over ``m`` points of grid ``cfg``.

    ``row_bytes`` is what a staged row takes in shared memory: 2 (int8 and
    float8 tables), 4 (bf16) or 8 (float32 tables; K2's accumulators).
    ``scatter`` says that the kernel adds into rows (K2), else it gathers
    them (K1)."""
    if cfg.n_levels > MAX_LEVELS:
        raise ValueError(f"the hash-grid kernels take <= {MAX_LEVELS} levels")
    if m < 0 or row_bytes not in (2, 4, 8):
        raise ValueError(f"no plan for {m} points and rows of {row_bytes} bytes")
    sizes = cfg.level_sizes
    if scatter:
        units, budget = cfg.n_levels, SCATTER_BUDGET  # a block holds one level's accumulators
        shared_bytes = max(sizes) * row_bytes
        # points whose corner adds outnumber the rows zeroed and flushed
        chunk_floor = -(-CHUNK_ADDS_PER_ROW * max(sizes) // (1 << cfg.n_dims))
        threads, chunk_step = STAGED_THREADS, STAGED_THREADS * RUN_POINTS
    else:
        # a block holds one group's slices
        units, budget = -(-cfg.n_levels // GROUP_LEVELS), SHARED_BUDGET
        shared_bytes = max(sum(sizes[lv:lv + GROUP_LEVELS])
                           for lv in range(0, cfg.n_levels, GROUP_LEVELS)) * row_bytes
        # points whose gathers outnumber the 16-byte loads of the copy
        chunk_floor = -(-GATHERS_PER_LOAD * (shared_bytes // 16) // (GROUP_LEVELS << cfg.n_dims))
        threads, chunk_step = GATHER_THREADS, GATHER_THREADS
    chunk = _round_up(max(-(-m // -(-TARGET_BLOCKS // units)), chunk_floor, 1), chunk_step)
    n_chunks = -(-m // chunk)
    if shared_bytes <= budget and units * n_chunks >= MIN_STAGED_BLOCKS:
        plan = LevelPlan(scatter, ("staged",) * cfg.n_levels, threads, chunk,
                         n_chunks, shared_bytes, units * n_chunks)
    else:
        run = 1
        if scatter:  # long runs only where they leave threads enough to fill the card
            run = RUN_POINTS
            while run > 1 and -(-m // run) * cfg.n_levels < MIN_DIRECT_THREADS:
                run //= 2
        plan = LevelPlan(scatter, ("direct",) * cfg.n_levels, DIRECT_THREADS, 0, 0,
                         0, -(-(-(-m // run) * cfg.n_levels) // DIRECT_THREADS), run)
    if plan.blocks > MAX_GRID:
        raise ValueError(f"{m} points are more than one launch of the hash-grid kernels takes")
    return plan
