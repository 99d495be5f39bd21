"""The least time of the pair-bucket cell's hash encodes, forward and
backward, counted from shapes, the same whatever implements the encode
(the exact gather of ``models/hash_grid.py`` or the kernels K1p, K1 and
K2). ``encode_roofline.pb`` divides it by the device time inside the
program's ``hash_encode.fwd`` and ``hash_encode.bwd`` spans.

Bytes of one encode of ``M`` points through a grid of ``L`` levels of
``F`` features, ``D`` dimensions and ``T`` rows: the forward reads the
float32 table once for its bf16 rounding (``4 F T``), the points
(``4 D M``) and writes the features (``4 L F M``), and of each level reads
at most ``2^D`` rows of ``2 F`` bytes (bf16) a point and at most the
level's rows. The backward reads the features' gradient (``4 L F M``),
writes the float32 table gradient once (``4 F T``), and of each level
touches at most ``2^D`` rows of ``4 F`` bytes a point and at most the
level's rows. Operations as ``roofline.encode_fwd`` / ``encode_bwd`` count
them, against the float32 peak; the least time of an encode is the larger
of its operations over the peak and its bytes over 3.35 TB/s."""

from __future__ import annotations

from perfbench import roofline
from perfbench.reference.ngp import Grid


def grids(pipeline_cfg: dict) -> dict[int, Grid]:
    """The position and surface hash grids by their dimensions."""
    ngp = pipeline_cfg["instant_ngp"]
    nested = ngp["surface_encoding"]["nested"][0]
    pos = Grid.of(ngp["encoding"], 3)
    surf = Grid.of(nested, int(nested["n_dims_to_encode"]))
    return {pos.dims: pos, surf.dims: surf}


def _rows_touched(grid: Grid, points: int) -> int:
    return sum(min((1 << grid.dims) * points, size) for size in grid.sizes)


def encode_bytes(grid: Grid, points: int, backward: bool) -> int:
    """The least bytes of one encode (or its backward) of ``points``."""
    f = grid.features
    features = 4 * grid.levels * f * points
    table = 4 * f * grid.rows
    if backward:
        return features + table + 4 * f * _rows_touched(grid, points)
    return table + 4 * grid.dims * points + features + 2 * f * _rows_touched(grid, points)


def least_seconds(pipeline_cfg: dict, traced: dict) -> float:
    """The least time of the encodes and their backwards in ``traced``
    (``work.train_work``'s records: (shapes, count) a kind of encode)."""
    by_dims = grids(pipeline_cfg)
    total = 0.0
    for key, backward in (("encode_fwd", False), ("encode_bwd", True)):
        for e, n in traced[key]:
            grid = by_dims[e["dims"]]
            assert grid.rows == e["rows"] and grid.levels == e["levels"], (grid, e)
            shapes = (e["points"], e["dims"], e["levels"], e["features"], e["rows"])
            flops = (roofline.encode_bwd if backward else roofline.encode_fwd)(*shapes)[0]
            nbytes = encode_bytes(grid, e["points"], backward)
            total += n * roofline.least_seconds(flops, nbytes)
    return total


def encoded_points(traced: dict, backward: bool) -> int:
    """Points of every encode (or backward) in ``traced``: what the
    program's spans around them count."""
    return sum(e["points"] * n for e, n in traced["encode_bwd" if backward else "encode_fwd"])
