"""Extraction traffic: whole extractions one after the other, as the
extract CLI makes them short of writing a file: the grid built on the host
(``get_extract_dataset``), then ``run_extraction`` in its batches, sigma
back on the host.

Set-up makes the granule and the parameters from the seed, builds the
program's dataset and pipeline, and runs ``warmup_extractions`` whole
extractions. The window runs whole extractions until ``seconds`` have
passed. The comparison, after the window: the reference rebuilds the
granule's rays (for the scene's normalization) and the grid's points, and
computes every point's extinction; compared are the widest gap of the
last extraction's points (metres) and of its sigma (over the reference's
largest sigma)."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import inputs, work
from perfbench.runners.common import Clock, counter_delta, finite, free_device_memory, \
    launch_counters, sync
from perfbench.runners.train import _granule_arrays
from perfbench.reference import geo, ngp, scene
from perfbench.trace import profiled


def run(run, seed: int, seconds: float, trace: bool, t0: float) -> None:
    from atmonr_tpu_torch import get_extract_dataset, get_pipeline, run_extraction
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset

    cfg, tr, dev = run.config, run.traffic, run.device
    clock = Clock(t0)
    granule = inputs.make_granule(tr["granule"], seed)
    t = clock.now()
    ds = HARP2Dataset(cfg["dataset"], _granule_arrays(granule), device=dev)
    run.spans["dataset_build_s"] = [clock.now() - t]
    pipe = get_pipeline(cfg["pipeline"], ds, device=dev)
    pipe.load_params(inputs.make_params(cfg["pipeline"], tr["params"], seed, dev))
    batch, grid_args = int(tr["batch_size"]), dict(tr["grid_args"])

    def extraction():
        a = time.perf_counter()
        grid = get_extract_dataset(tr["grid"], ds, **grid_args)
        b = time.perf_counter()
        sigma = run_extraction(pipe, grid, batch_size=batch)
        c = time.perf_counter()
        return grid, sigma, b - a, c - b

    for _ in range(int(tr["warmup_extractions"])):
        extraction()
    sync(dev)
    run.setup_s = clock.now()

    before = launch_counters()
    done, points, bad = 0, 0, 0
    run.spans.update(grid_build_s=[], query_s=[])
    start = time.perf_counter()
    while True:
        grid, sigma, tg, tq = extraction()
        done += 1
        points += len(grid)
        bad += int(not np.isfinite(sigma).all())
        run.spans["grid_build_s"].append(tg)
        run.spans["query_s"].append(tq)
        if time.perf_counter() - start >= seconds:
            break
    run.window_s = time.perf_counter() - start
    run.counters = counter_delta(before, launch_counters())
    run.work = {"extractions": done, "points": points, "points_per_extraction": len(grid),
                "flops": work.query_work(cfg["pipeline"], len(grid), batch, done)["flops"]}
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.attempted, run.failed = done, bad

    if trace:
        n, out = int(tr["trace_extractions"]), {}
        with profiled(dev, out):
            for _ in range(n):
                extraction()
        run.trace = out["trace"]
        run.traced = work.query_work(cfg["pipeline"], len(grid), batch, n)

    xyz, sigma = np.array(grid.xyz), np.array(sigma)
    del pipe, ds, grid, extraction
    free_device_memory()

    check_start = time.perf_counter()
    sc = scene.build_scene(granule, cfg["dataset"], dev)
    p = inputs.make_params(cfg["pipeline"], tr["params"], seed, dev)
    ref_xyz = geo.l1c_points(sc.lat, sc.lon, sc.alt, sc.image_shape, float(grid_args["alt_step"]),
                             sc.origin_height)
    ref = reference_sigma(cfg, sc, p, ref_xyz, batch)
    run.readings = compare(xyz, sigma, ref_xyz, ref)
    run.checks = dict(run.readings)
    run.spans["check_s"] = [time.perf_counter() - check_start]
    for variant in getattr(run, "variants", ()):
        # the lower-precision control in the program's place, for setting limits
        parts = dict(part.split(":", 1) for part in variant.split("+"))
        xyz_v = ref_xyz
        if parts.get("grid") == "f32":
            xyz_v = geo.l1c_points(sc.lat, sc.lon, sc.alt, sc.image_shape,
                                   float(grid_args["alt_step"]), sc.origin_height, np.float32)
        ctl = reference_sigma(cfg, sc, p, xyz_v, batch, parts.get("table"))
        run.readings[variant] = compare(xyz_v, ctl[:, None], ref_xyz, ref)


def reference_sigma(cfg: dict, sc, params: dict, xyz: np.ndarray, batch: int,
                    fmt: str | None = None) -> np.ndarray:
    """Extinction in m^-1 at ECEF points, in the query's batches: the MLPs'
    bfloat16 products then meet the same matrix shapes as the program's."""
    model = ngp.Model(cfg["pipeline"], sc, table_format=fmt)
    pts = torch.from_numpy(((xyz - sc.offset[None]) / sc.scale).astype(np.float32))
    out = []
    for i in range(0, pts.shape[0], batch):
        chunk = pts[i:i + batch].to(params["pos_table"].device)
        out.append((model.extinction(params, chunk) / sc.scale).cpu())
    return torch.cat(out).numpy()


def compare(xyz, sigma, ref_xyz, ref_sigma) -> dict:
    """Widest gaps: of the grid's points in metres, and of sigma over the
    reference's largest sigma."""
    if xyz.shape != ref_xyz.shape or sigma.shape[0] != ref_sigma.shape[0]:
        return {"grid_gap_m": float("inf"), "sigma_gap": float("inf")}
    gap = np.abs(sigma.reshape(sigma.shape[0], -1)[:, 0].astype(np.float64) - ref_sigma)
    return {"grid_gap_m": finite(float(np.abs(xyz - ref_xyz).max())),
            "sigma_gap": finite(float(gap.max()) / float(np.abs(ref_sigma).max()))}
