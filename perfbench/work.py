"""The work of the Instant-NGP cells, counted from the configuration's
shapes: which hash encodes and gradients a train step or a query batch
runs, at how many points, and its model FLOPs (MLP products and encode
interpolation). The roofline and utilization metrics divide these by
measured time."""

from __future__ import annotations

from perfbench import roofline
from perfbench.reference.ngp import Grid, param_shapes


def _grids(pipeline_cfg: dict) -> tuple[Grid, Grid]:
    ngp = pipeline_cfg["instant_ngp"]
    nested = ngp["surface_encoding"]["nested"]
    return Grid.of(ngp["encoding"], 3), Grid.of(nested[0], int(nested[0]["n_dims_to_encode"]))


def _layers(pipeline_cfg: dict, net: str) -> list[tuple[int, int]]:
    return [v for k, v in param_shapes(pipeline_cfg).items() if k.startswith(net + ".")]


def _enc(grid: Grid, points: int, noise: bool = False) -> dict:
    return {"points": points, "dims": grid.dims, "levels": grid.levels,
            "features": grid.features, "rows": grid.rows, "noise": noise}


def train_work(pipeline_cfg: dict, batch: int, steps: int, refreshes: int) -> dict:
    """``steps`` train steps of ``batch`` rays with ``refreshes`` occupancy
    refreshes among them: encode forwards and gradients (each a dict of
    shapes with its count) and the model FLOPs."""
    pos, surf = _grids(pipeline_cfg)
    ngp = pipeline_cfg["instant_ngp"]
    occ = pipeline_cfg["occupancy"]
    m = batch * int(occ["n_fine"])
    cells = 1
    for r in occ["resolution"]:
        cells *= int(r)
    sr = bool(ngp["encoding"].get("stochastic_rounding", False))
    fwd = [(_enc(pos, m, sr), steps), (_enc(surf, batch), steps), (_enc(pos, cells), refreshes)]
    bwd = [(_enc(pos, m), steps), (_enc(surf, batch), steps)]
    flops = steps * (roofline.mlp_flops(m, _layers(pipeline_cfg, "pos_mlp"), True)
                     + roofline.mlp_flops(m, _layers(pipeline_cfg, "dir_mlp"), True)
                     + roofline.mlp_flops(batch, _layers(pipeline_cfg, "surf_mlp"), True))
    flops += refreshes * roofline.mlp_flops(cells, _layers(pipeline_cfg, "pos_mlp"), False)
    flops += sum(roofline.encode_fwd(**e)[0] * n for e, n in fwd)
    flops += sum(roofline.encode_bwd(**{k: v for k, v in e.items() if k != "noise"})[0] * n
                 for e, n in bwd)
    return {"encode_fwd": fwd, "encode_bwd": bwd, "flops": flops, "steps": steps}


def query_work(pipeline_cfg: dict, points: int, batch: int, extractions: int) -> dict:
    """``extractions`` whole queries of ``points`` points in batches of
    ``batch``: one position encode a batch and the density MLP's forward."""
    pos, _ = _grids(pipeline_cfg)
    full, tail = divmod(points, batch)
    fwd = [(_enc(pos, batch), full * extractions)] + ([(_enc(pos, tail), extractions)] if tail else [])
    flops = extractions * roofline.mlp_flops(points, _layers(pipeline_cfg, "pos_mlp"), False)
    flops += sum(roofline.encode_fwd(**e)[0] * n for e, n in fwd)
    return {"encode_fwd": fwd, "encode_bwd": [], "flops": flops, "extractions": extractions}


def least_encode_seconds(records: list, backward: bool) -> float:
    """The least time of a list of (shapes, count) encode records."""
    total = 0.0
    for e, n in records:
        if backward:
            f, b = roofline.encode_bwd(**{k: v for k, v in e.items() if k != "noise"})
        else:
            f, b = roofline.encode_fwd(**e)
        total += n * roofline.least_seconds(f, b)
    return total
