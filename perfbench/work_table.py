"""The work of an extraction batch on the 2^21 position table of
``ngp_occ21``, counted from the configuration's shapes: the table's bf16
preparation (K1p's bf16 instance, ``round_bf16_kernel``) and the gather
from the prepared table (K1 bf16). The ``.extract21`` rooflines divide
these by the kernels' device time.

A query prepares the table once a batch, before the batch's one position
encode, so the profiled extractions' preparations are their encodes
(``perfbench/work.py``'s ``encode_fwd`` records)."""

from __future__ import annotations

from perfbench import roofline
from perfbench.reference.ngp import Grid

PREP_KERNEL = r"round_bf16_kernel"
GATHER_KERNEL = r"hash_gather_"
BF16_ROW_BYTES = 4  # two bfloat16 features


def position_grid(pipeline_cfg: dict) -> Grid:
    return Grid.of(pipeline_cfg["instant_ngp"]["encoding"], 3)


def preparations(traced: dict) -> int:
    """The table preparations of the profiled extractions: one a batch."""
    return sum(n for _, n in traced["encode_fwd"])


def prep_least_seconds(pipeline_cfg: dict) -> float:
    """Least time of one preparation: the float32 master table read once
    (8 bytes a row) over the memory rate. The bfloat16 table it writes (4
    bytes a row, 84.6 MB at 2^21) is left out: up to the card's 50 MB of L2
    can still hold the write when the kernel ends, so the time measured
    need not cover it, and counting it could put the share above 100%."""
    grid = position_grid(pipeline_cfg)
    return grid.rows * grid.features * 4 / roofline.PEAK_BYTES


def gather_least_seconds(pipeline_cfg: dict, points: int) -> float:
    """Least time of K1 bf16 D=3 at ``points`` points: the float32 points
    read and the float32 features written once, and of the table at each
    level at most 8 rows (the cell's corners) of 4 bytes a point, and at
    most the level's rows, over the memory rate; against the interpolation's
    FLOPs (``roofline.encode_fwd``) at the float32 peak."""
    grid = position_grid(pipeline_cfg)
    corners = 1 << grid.dims
    flops, _ = roofline.encode_fwd(points, grid.dims, grid.levels, grid.features, grid.rows)
    nbytes = points * grid.dims * 4 + points * grid.levels * grid.features * 4
    nbytes += sum(min(corners * points, size) for size in grid.sizes) * BF16_ROW_BYTES
    return roofline.least_seconds(flops, nbytes)


def gather_least_seconds_of(pipeline_cfg: dict, traced: dict) -> float:
    """The least time of every position gather in the profiled extractions."""
    return sum(n * gather_least_seconds(pipeline_cfg, e["points"]) for e, n in traced["encode_fwd"])
