#!/usr/bin/env python3
"""Smoke run of atmonr_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. Build: compiles every CUDA kernel of the port from ``atmonr_tpu_torch/csrc``
   (``nvcc`` for sm_90a, into ``atmonr_tpu_torch/_build``) and prints the
   build time and ``ptxas``'s register report.
3. Kernels, each against its plain PyTorch version on the card at the
   flagship's shapes (3-D pos grid at M = 196,608; 2-D surface grid at
   M = 8,192), timed (CUDA-graph replay; per call with the host launch)
   beside its bound. K1 (the q8 hash gather), deterministic and with
   stochastic-rounding noise: max abs error <= 1e-6 * max|output|. K2 (the
   hash-table gradient, float32 atomics, so not bit-reproducible): max abs
   error <= 1e-5 * max|dW| on uniform points.
4. Slice: loads ``configs/instant_ngp_tpu_occ13.json`` unchanged, builds a
   ``synthetic:128x64x2`` granule and the pipeline on the card (random
   weights from seed 0), refreshes the occupancy grid once, renders 4 batches
   of 8,192 rays deterministically and 1 with a generator, and checks the
   outputs and that K1 ran for both grids on every forward. Then renders one
   batch on the card and on the CPU with float32 MLP products and compares.
   Profiles one forward and one refresh (device time by kernel; idle share of
   the unprofiled median call).
5. Extraction: ``run_extraction`` over 1,048,576 points along the granule's
   rays, in 32,768-point batches.
6. Train: ``Trainer`` on the same config and granule at full width, 8,192
   rays per step, 192 steps (past ``restart_on_plateau.check_iter`` = 150,
   12 occupancy refreshes, epoch ends with metrics and checkpoints). Checks
   that every loss is finite, that the loss fell, and that K1 and K2 ran
   once per grid per step (K1 once more per refresh). Then times 16-step
   blocks of steady steps, profiles one step, holds K2 to its plain
   version on one forward's own sample points (<= 1e-4 * max|dW|: they
   cluster, and a row sums tens of thousands of terms in two orders), and
   compares one step's hash-table gradients on the card and on the CPU.

Each main path (phases 4-5, and phase 6) has every launch count set to 0
just before it and read just after it. The second-to-last line is a JSON
object with one entry per kernel; the last line is the result,
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "instant_ngp_tpu_occ13.json"
SCENE = "synthetic:128x64x2"
BATCH = 8192
N_EXTRACT = 1 << 20
# H100 SXM published peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
K1_SOURCE = "atmonr_tpu_torch/csrc/hash_gather.cu"
K1_REPLACES = "atmonr_tpu/ops/hash_gather_pallas.py:404"
K2_SOURCE = "atmonr_tpu_torch/csrc/hash_bwd.cu"
K2_REPLACES = "atmonr_tpu/ops/hash_bwd_pallas.py:183"
K2_NO_LIBRARY = "no single PyTorch call computes the index math and the scatter"
TRAIN_STEPS = 192
# One step's hash-table gradients of the trained model, card against CPU.
# The float32 ECEF -> lat/lon/alt preprocessor solves the altitude by a
# cancelling difference, and its sin/cos/arctan2 differ by ulps between the
# card and the CPU: ~1e-4 of the normalized altitude, 2% of a cell of the
# finest level, which alone moves the table gradient by ~1% (measured). So
# the CPU pipeline takes the card's preprocessed points here. The samplers
# are discontinuous, so up to 2% of the rays may still place a sample
# elsewhere (depths beyond rtol 1e-4); the step is compared on the other
# rays. Depths that agree to 1e-5 still move a point by ~0.2% of a cell of
# the finest level, so rows outside rtol + atol * max|g| may be at most
# GRAD_BAD_ROWS of the touched rows (measured 0.03-0.13%), and the whole
# gradient must agree to the relative L2 error GRAD_REL_L2 (measured
# 1.6e-4 to 5.5e-4; 7.4e-3 with each device's own preprocessor).
SAME_SAMPLES_RTOL, SAME_SAMPLES_MISS = 1e-4, 0.02
GRAD_RTOL, GRAD_ATOL, GRAD_BAD_ROWS, GRAD_REL_L2 = 1e-3, 1e-4, 0.01, 3e-3
BLOCK = 16  # steps per timed block: one occupancy refresh inside each


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of per-call CUDA event times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, per_graph: int = 20, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``per_graph`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events; the median replay
    over ``per_graph``. Replay leaves out the host's per-call launch work,
    which ``median_ms`` includes."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def k1_bound(m: int, cfg) -> tuple[float, str]:
    """Least time for K1 on (m, D) points: each input read once and each
    output written once over the memory rate, against its float32
    operations (5D per point and level for the cell math, D+4 per corner
    for the weight and the two features' multiply-add and conversion, and 2
    for the scale) over the float32 peak."""
    d, n_levels = cfg.n_dims, cfg.n_levels
    n_bytes = m * d * 4 + m * cfg.n_output_dims * 4 + cfg.total_params * 2 + n_levels * 4
    ops = m * n_levels * (5 * d + (1 << d) * (d + 4) + 2)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k2_bound(m: int, cfg) -> tuple[float, str, int]:
    """Least time for K2 on (m, D) points: positions and cotangent read
    once and the table cotangent written once over the memory rate, against
    its float32 operations (5D per point and level for the cell math, D + 2
    per corner for the weight and the two products, 2 adds per atomic) over
    the float32 peak. Also returns the number of float2 atomics."""
    d, n_levels = cfg.n_dims, cfg.n_levels
    n_bytes = m * d * 4 + m * cfg.n_output_dims * 4 + cfg.total_params * 8
    atomics = m * n_levels * (1 << d)
    ops = m * n_levels * (5 * d + (1 << d) * (d + 4))
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", atomics


def reset_counts() -> None:
    from atmonr_tpu_torch.ops.hash_bwd import hash_bwd
    from atmonr_tpu_torch.ops.hash_gather import hash_gather_q8

    for counts in (hash_gather_q8.launches, hash_bwd.launches):
        for d in counts:
            counts[d] = 0


def read_counts() -> dict:
    from atmonr_tpu_torch.ops.hash_bwd import hash_bwd
    from atmonr_tpu_torch.ops.hash_gather import hash_gather_q8

    return {"K1": dict(hash_gather_q8.launches), "K2": dict(hash_bwd.launches)}


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # float32 products in full float32 (TF32 off), stated for the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build() -> None:
    from atmonr_tpu_torch import _build

    t0 = time.perf_counter()
    built = _build.build_all(("hash_gather", "hash_bwd"), verbose=True)
    log(f"[build] {len(built)} libraries, one nvcc each, together in "
        f"{time.perf_counter() - t0:.2f} s")
    for path, report in built.values():
        log(f"[build] {path.name}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")


def check_k2(x: torch.Tensor, g: torch.Tensor, cfg, tol: float, what: str) -> dict:
    """K2 against its plain version on (x, g): raises unless the largest
    difference is within ``tol * max|dW|``; returns the error and the times
    (device ms by graph replay, zero-fill of the output included; per call
    with the host launch; plain)."""
    from atmonr_tpu_torch.models.hash_grid import level_indices
    from atmonr_tpu_torch.ops import hash_bwd as hbo

    d = cfg.n_dims
    before = hbo.hash_bwd.launches[d]
    got = hbo.hash_bwd(x, g, cfg)
    torch.cuda.synchronize()
    if hbo.hash_bwd.launches[d] != before + 1:
        raise RuntimeError("K2 launch counter did not move")
    want = hbo.hash_bwd_plain(x, g, cfg)
    # the same sum in float64, to place both float32 sums
    ref = torch.zeros((cfg.total_params, 2), dtype=torch.float64, device=x.device)
    for level in range(cfg.n_levels):
        idx, w = level_indices(x, cfg, level)
        vals = w.double()[..., None] * g[:, None, 2 * level:2 * level + 2].double()
        ref.index_add_(0, (cfg.level_offsets[level] + idx).reshape(-1), vals.reshape(-1, 2))
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = got.shape == want.shape and got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    if not (ok and err <= tol * scale):
        raise RuntimeError(f"K2 {what} disagrees: max abs err {err} vs {tol} * max|dW| {scale}")
    call_ms = median_ms(lambda: hbo.hash_bwd(x, g, cfg), reps=50, warmup=10)
    ms = graph_ms(lambda: hbo.hash_bwd(x, g, cfg))
    plain_ms = median_ms(lambda: hbo.hash_bwd_plain(x, g, cfg), reps=5)
    bound_ms, bound_by, atomics = k2_bound(x.shape[0], cfg)
    log(f"[kernel] K2 {what} D={d} M={x.shape[0]}: max abs err {err:.3g} = "
        f"{err / scale:.2g} of max|dW| (tolerance {tol:g}; against the float64 sum: kernel "
        f"{float((got - ref).abs().max()) / scale:.2g}, plain "
        f"{float((want - ref).abs().max()) / scale:.2g}), device {ms:.4f} ms, per call with "
        f"launch {call_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {atomics / 1e6:.1f} M float2 atomics), library ms null: {K2_NO_LIBRARY}")
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels(encodings: dict) -> list[dict]:
    """K1 and K2 against their plain versions at the flagship shapes, on
    uniform random points."""
    from atmonr_tpu_torch.models import hash_grid as hg
    from atmonr_tpu_torch.ops import hash_gather as hgo

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for label, n_dims, m in (("pos", 3, 196_608), ("surface", 2, 8_192)):
        cfg = hg.HashGridConfig.from_options(encodings[label], n_dims)
        table = torch.rand((cfg.total_params, 2), generator=gen, device=dev) * 2e-4 - 1e-4
        noise = torch.rand(table.shape, generator=gen, device=dev)
        x = torch.rand((m, n_dims), generator=gen, device=dev)
        err = 0.0
        for u in (None, noise):
            q, s = hgo.quantize_tables_q8(table, cfg, u)
            before = hgo.hash_gather_q8.launches[n_dims]
            got = hgo.hash_gather_q8(q, s, x, cfg)
            torch.cuda.synchronize()
            if hgo.hash_gather_q8.launches[n_dims] != before + 1:
                raise RuntimeError("K1 launch counter did not move")
            want = hgo.hash_gather_q8_plain(q, s, x, cfg)
            diff = float((got - want).abs().max())
            scale = float(want.abs().max())
            if not (got.shape == want.shape and torch.isfinite(got).all() and diff <= 1e-6 * scale):
                raise RuntimeError(f"K1 {label} disagrees: max abs err {diff} vs max|out| {scale}")
            err = max(err, diff)
        call_ms = median_ms(lambda: hgo.hash_gather_q8(q, s, x, cfg), reps=50, warmup=10)
        ms = graph_ms(lambda: hgo.hash_gather_q8(q, s, x, cfg))
        plain_ms = median_ms(lambda: hgo.hash_gather_q8_plain(q, s, x, cfg), reps=10)
        bound_ms, bound_by = k1_bound(m, cfg)
        log(f"[kernel] K1 q8 {label} D={n_dims} M={m}: max abs err {err:.3g} "
            f"(tolerance 1e-6 * max|out|), device {ms:.4f} ms, per call with launch "
            f"{call_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows.append({
            "name": f"hash_gather_q8 D={n_dims} ({label} grid)", "route": "cuda",
            "source": K1_SOURCE, "replaces": K1_REPLACES, "kernel": "K1", "n_dims": n_dims,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        g = torch.randn((m, cfg.n_output_dims), generator=gen, device=dev)
        k2 = check_k2(x, g, cfg, 1e-5, f"{label}, uniform points,")
        rows.append({
            "name": f"hash_bwd D={n_dims} ({label} grid)", "route": "cuda",
            "source": K2_SOURCE, "replaces": K2_REPLACES, "kernel": "K2", "n_dims": n_dims,
            "launches": 0, "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
            "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"], "library_ms": None,
        })
    return rows


def _check_render(out: dict, b: int, n_fine: int) -> None:
    shapes = {
        "color_map_fine": (b, 4), "color_surf": (b, 4), "color_map_atmo": (b, 4),
        "color_map_surf": (b, 4), "z_vals_fine": (b, n_fine),
        "weights_fine": (b, n_fine, 1), "sigma_fine": (b, n_fine - 1, 1),
        "color_fine": (b, n_fine - 1, 4),
    }
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp or not torch.isfinite(out[k]).all():
            raise RuntimeError(f"render output {k}: shape {tuple(out[k].shape)}, want {shp}, "
                               "or not finite")


def phase_slice(card: str) -> tuple[dict, dict]:
    """The main path: occupancy refresh, renders, extraction. Returns the
    launch counts of the window and the objects the comparison reuses."""
    from atmonr_tpu_torch import get_dataset, get_pipeline, load_config, run_extraction
    from atmonr_tpu_torch.ops import hash_gather as hgo

    config = load_config(CONFIG)
    t0 = time.perf_counter()
    ds = get_dataset(config["dataset"], SCENE)
    pipe = get_pipeline(config["pipeline"], ds, generator=torch.Generator().manual_seed(0))
    rays = ds.rays()
    n_rays = len(ds)
    log(f"[slice] {SCENE}: {n_rays} rays, pipeline on {pipe.device} in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    if n_rays < 6 * BATCH:
        raise RuntimeError("granule too small for the batches")
    batches = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in rays.items()} for i in range(6)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_fine = pipe.occ_cfg.n_fine

    # warm-up outside the window (cuBLAS handles, allocator)
    pipe.update_aux()
    with torch.no_grad():
        pipe(batches[5])
    pipe.init_aux()
    torch.cuda.synchronize()

    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    pipe.update_aux(generator=gen)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    if hgo.hash_gather_q8.launches[3] != 1:
        raise RuntimeError("occupancy refresh did not launch K1 once")
    fwd_s = []
    for i in range(5):
        before = dict(hgo.hash_gather_q8.launches)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = pipe(batches[i], generator=gen if i == 4 else None)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        _check_render(out, BATCH, n_fine)
        after = hgo.hash_gather_q8.launches
        if after[3] != before[3] + 1 or after[2] != before[2] + 1:
            raise RuntimeError(f"forward {i} did not launch K1 once per grid: {before} -> {after}")

    # extraction over points along the granule's own rays
    host = ds.host_rays()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, n_rays, N_EXTRACT)
    t = rng.uniform(0.0, 1.0, N_EXTRACT) * host["len"][idx]
    pts = host["origin"][idx].astype(np.float64) + host["dir"][idx] * t[:, None]
    xyz = pts * ds.scale + ds.offset[None]
    t0 = time.perf_counter()
    sigma = run_extraction(pipe, xyz, batch_size=32768)
    extract_s = time.perf_counter() - t0
    all_counts = read_counts()
    counts = all_counts["K1"]
    # ---- end of the main path ----

    n_batches = -(-N_EXTRACT // 32768)
    if sigma.shape != (N_EXTRACT, 1) or not np.all(np.isfinite(sigma)) or np.any(sigma < 0):
        raise RuntimeError("extraction result not finite, non-negative, (N, 1)")
    if counts != {3: 1 + 5 + n_batches, 2: 5} or all_counts["K2"] != {2: 0, 3: 0}:
        raise RuntimeError(f"launches on the inference path: {all_counts}")
    steady = statistics.median(fwd_s[1:4])
    log(f"[slice] occupancy refresh ({pipe.occ_cfg.num_cells} cells): {refresh_s * 1e3:.2f} ms, "
        f"{pipe.occ_cfg.num_cells / refresh_s:.0f} cells/s on {card}")
    log(f"[slice] forward of {BATCH} rays (key=None, median of batches 2-4): "
        f"{steady * 1e3:.2f} ms = {BATCH / steady:.0f} rays/s on {card}; all five: "
        + ", ".join(f"{s * 1e3:.2f}" for s in fwd_s) + " ms")
    log(f"[extract] {N_EXTRACT} points in {n_batches} batches: {extract_s:.3f} s = "
        f"{N_EXTRACT / extract_s:.0f} points/s on {card}; sigma max {float(sigma.max()):.3g} m^-1")
    log(f"[slice] K1 launches on the inference path: D=3 {counts[3]}, D=2 {counts[2]}; K2 none")
    return all_counts, {"config": config, "ds": ds, "pipe": pipe, "batch": batches[0]}


def log_profile(prof, label: str, unprofiled_us: float, wall_us: float, card: str,
                top: int) -> None:
    """Device time by kernel of one profiled call, and the card's idle
    share over the unprofiled call and over the profiled one."""
    # kernels and copies; not the device-side ranges of user annotations
    # (the optimizer's "Optimizer.step#AdamW.step"), which span their kernels
    events = prof.events()
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    kernels = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
        and e.name not in annotations
    ]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total)
    log(f"[profile] {label}: device busy {busy_us:.0f} us in {len(kernels)} kernels; "
        f"idle {1 - busy_us / unprofiled_us:.1%} of the unprofiled median call "
        f"({unprofiled_us:.0f} us), {1 - busy_us / wall_us:.1%} of the profiled call "
        f"({wall_us:.0f} us), on {card}")
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]:
        log(f"[profile]   {sum(ts):8.1f} us  x{len(ts):<4d} {name[:90]}")


def phase_profile(ctx: dict, card: str) -> None:
    """Steady-state times of the deterministic forward (8,192 rays) and of
    the occupancy refresh (host clock around calls that end in a
    synchronize, after a warm-up call), and where the time of one call of
    each goes: device time by kernel (torch.profiler). The card's idle share
    is one less the device time over the unprofiled median call; the share
    over the profiled call's own wall time, which the profiler lengthens, is
    printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    pipe, batch = ctx["pipe"], ctx["batch"]

    @torch.no_grad()
    def forward():
        pipe(batch)

    for label, fn, reps in (("forward", forward, 20), ("refresh", pipe.update_aux, 10)):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        rate = f"{BATCH / med:.0f} rays/s" if label == "forward" else \
            f"{pipe.occ_cfg.num_cells / med:.0f} cells/s"
        log(f"[steady] {label}: median of {reps} calls {med * 1e3:.2f} ms = {rate}, "
            f"min {min(times) * 1e3:.2f} ms, max {max(times) * 1e3:.2f} ms, on {card}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        log_profile(prof, label, med * 1e6, wall_us, card, top=6)


def phase_card_vs_cpu(ctx: dict) -> None:
    """One batch on the card and on the CPU, float32 MLP products on both.

    Tolerance: rtol 1e-4 plus 1e-6 of each output's largest value, on the
    rendered color, the surface color and the sample placement. The
    samplers are discontinuous and float32 sin/cos/arctan2 differ by ulps
    between the card and the CPU, so up to 1% of the rays may take other
    samples; every other ray must agree."""
    from atmonr_tpu_torch import get_pipeline

    pipe, batch = ctx["pipe"], ctx["batch"]
    cpu = get_pipeline(ctx["config"]["pipeline"], ctx["ds"], device="cpu")
    cpu.load_state_dict(pipe.state_dict())
    pipe.compute_dtype = cpu.compute_dtype = torch.float32
    with torch.no_grad():
        out_card = pipe(batch)
        out_cpu = cpu({k: v.cpu() for k, v in batch.items()})
    bad = torch.zeros(BATCH, dtype=torch.bool)
    worst = {}
    for k in out_cpu:
        a, b = out_card[k].cpu(), out_cpu[k]
        worst[k] = f"{float((a - b).abs().max()):.3g} of {float(b.abs().max()):.3g}"
        if k in ("color_map_fine", "color_surf", "z_vals_fine"):
            err = (a - b).abs() > 1e-4 * b.abs() + 1e-6 * b.abs().max()
            bad |= err.reshape(BATCH, -1).any(dim=1)
    share = float(bad.float().mean())
    log(f"[compare] card vs CPU, {BATCH} rays, float32: {int(bad.sum())} rays "
        f"({share:.4%}) outside rtol 1e-4 in color, surface color or depths; "
        f"max abs err of max|out|: {worst}")
    if share > 0.01:
        raise RuntimeError("card and CPU renders disagree on more than 1% of the rays")


def _table_grads(pipe, batch, draws) -> dict:
    pipe.zero_grad()
    pipe.compute_loss(batch, pipe(batch, draws=draws)).backward()
    return {"pos_table": pipe.pos_table.grad, "surf_enc": pipe.surf_enc["0"].grad}


def phase_train(ctx: dict, card: str, rows: list[dict]) -> dict:
    """The training main path: ``Trainer.iterate`` for ``TRAIN_STEPS`` steps
    on the flagship config at full width. Returns the launch counts of the
    window."""
    from atmonr_tpu_torch import Trainer, get_pipeline
    from atmonr_tpu_torch.data import batching
    from torch.profiler import ProfilerActivity, profile

    config, ds = ctx["config"], ctx["ds"]
    tcfg = dict(config["trainer"], num_iters=TRAIN_STEPS)
    pipe = get_pipeline(config["pipeline"], ds)
    every = pipe.occ_cfg.update_every
    rop = tcfg["restart_on_plateau"]
    if TRAIN_STEPS <= rop["check_iter"] or TRAIN_STEPS // every < 10 or BLOCK % every:
        raise RuntimeError("the train phase must pass check_iter and 10 refreshes")
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(tcfg, ds, pipe, "chip_smoke", data_root=root, seed=0)
        if trainer.batch_size != BATCH or trainer.micro_batch is not None:
            raise RuntimeError(f"batch size {trainer.batch_size}, micro {trainer.micro_batch}")
        log(f"[train] {TRAIN_STEPS} steps of {BATCH} rays, {trainer.steps_per_epoch} steps per "
            f"epoch, refresh every {every}, restart check at {rop['check_iter']}")

        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        losses, block_s = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in trainer.iterate(Path(root) / "output"):
            losses.append(trainer.last_loss)
            if it % BLOCK == 0:
                torch.cuda.synchronize()
                now = time.perf_counter()
                block_s.append(now - t0)
                t0 = now
        counts = read_counts()
        # ---- end of the main path ----
        n_ckpt = len(list((Path(root) / "output").glob("epoch_*.pt")))

    loss = torch.stack(losses).cpu()
    if trainer.iter_count != TRAIN_STEPS or loss.shape != (TRAIN_STEPS,):
        raise RuntimeError(f"ran {trainer.iter_count} steps, {loss.shape} losses")
    if not bool(torch.isfinite(loss).all()):
        raise RuntimeError("a training loss is not finite")
    # a run that restart_on_plateau re-initialised at check_iter is judged
    # on the steps before the restart
    restarted = trainer._restart_base > 0
    end = trainer._restart_base if restarted else TRAIN_STEPS
    first, last = float(loss[:BLOCK].mean()), float(loss[end - BLOCK:end].mean())
    log(f"[train] loss: first {BLOCK} steps {first:.4f}, steps {end - BLOCK + 1}-{end} "
        f"{last:.4f}; re-initialised at the restart check: {restarted}; "
        f"{trainer.epoch_idx} epochs, {n_ckpt} checkpoints")
    if not last < first:
        raise RuntimeError(f"the loss did not fall: {first} -> {last}")
    want = {"K1": {3: TRAIN_STEPS + TRAIN_STEPS // every, 2: TRAIN_STEPS},
            "K2": {3: TRAIN_STEPS, 2: TRAIN_STEPS}}
    if counts != want:
        raise RuntimeError(f"launches on the training path: {counts}, expected {want}")
    log(f"[train] launches on the training path: K1 D=3 {counts['K1'][3]} (one per step and "
        f"per refresh), K1 D=2 {counts['K1'][2]}, K2 D=3 {counts['K2'][3]}, K2 D=2 "
        f"{counts['K2'][2]}")
    per_step = sorted(1e3 * s / BLOCK for s in block_s)
    log(f"[train] Trainer.iterate, epoch ends (metrics, checkpoint) and loss logging "
        f"inside: median of {len(block_s)} blocks of {BLOCK} steps "
        f"{statistics.median(per_step):.2f} ms per step = "
        f"{BATCH / statistics.median(per_step) * 1e3:.0f} rays/s, min {per_step[0]:.2f}, "
        f"max {per_step[-1]:.2f} ms, on {card}")

    # steady steps: blocks of BLOCK steps (one refresh inside each), no epoch end
    perm = batching.epoch_permutation(trainer.generators["perm"], trainer.num_rays, BATCH)
    idx = [perm[i * BATCH:(i + 1) * BATCH] for i in range(trainer.steps_per_epoch)]
    steady = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(BLOCK):
            trainer.step(idx[i % len(idx)])
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) / BLOCK)
    med = statistics.median(steady)
    log(f"[steady] train step of {BATCH} rays (median of 8 blocks of {BLOCK} steps, one "
        f"refresh in each): {med * 1e3:.2f} ms = {BATCH / med:.0f} rays/s, min "
        f"{min(steady) * 1e3:.2f}, max {max(steady) * 1e3:.2f} ms, on {card}")
    before = read_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(idx[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    after = read_counts()
    if [after[k][d] - before[k][d] for k in ("K1", "K2") for d in (3, 2)] != [1, 1, 1, 1]:
        raise RuntimeError(f"the profiled step's launches: {before} -> {after}")
    log_profile(prof, "train step (no refresh)", med * 1e6, wall_us, card, top=10)

    # K2 on one forward's own sample points of the trained model: they
    # cluster where the occupancy grid sends them, and contend
    batch = batching.gather_batch(trainer.rays, idx[1])
    draws = pipe.make_draws(BATCH, trainer.generators["draws"])
    x, _ = pipe.sample_points(batch, draws)
    g = torch.randn((x.shape[0], pipe.pos_cfg.n_output_dims), device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(11))
    own = check_k2(x, g, pipe.pos_cfg, 1e-4, "pos, one forward's own sample points,")
    row = next(r for r in rows if r["kernel"] == "K2" and r["n_dims"] == 3)
    row.update(ms_uniform_points=row["ms"], ms=own["ms"], plain_ms=own["plain_ms"],
               max_abs_err=max(row["max_abs_err"], own["max_abs_err"]))

    # one step's hash-table gradients on the card and on the CPU, float32
    # MLPs, one preprocessor, on the rays that take the same samples on both
    cpu = get_pipeline(config["pipeline"], ds, device="cpu")
    cpu.load_state_dict(pipe.state_dict())
    cpu.point_preprocessor = lambda pts: pipe.point_preprocessor(pts.to(pipe.device)).cpu()
    pipe.compute_dtype = cpu.compute_dtype = torch.float32
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    draws_cpu = {k: v.cpu() for k, v in draws.items()}
    z_card, z_cpu = pipe.sample_points(batch, draws)[1].cpu(), cpu.sample_points(batch_cpu, draws_cpu)[1]
    rel = ((z_card - z_cpu).abs() / z_cpu.abs()).amax(dim=1)
    same = rel <= SAME_SAMPLES_RTOL
    log(f"[compare] {int(same.sum())} of {BATCH} rays take the same samples on the card and "
        f"on the CPU (depths to rtol {SAME_SAMPLES_RTOL:g}; {int((rel <= 1e-5).sum())} to 1e-5, "
        f"{int((rel <= 1e-3).sum())} to 1e-3)")
    if float(same.float().mean()) < 1 - SAME_SAMPLES_MISS:
        raise RuntimeError(f"more than {SAME_SAMPLES_MISS:.0%} of the rays take other samples "
                           "on the card")

    def keep(tensors, mask):
        return {k: v if k == "sr_noise" else v[mask] for k, v in tensors.items()}

    g_card = _table_grads(pipe, keep(batch, same.to(pipe.device)), keep(draws, same.to(pipe.device)))
    g_cpu = _table_grads(cpu, keep(batch_cpu, same), keep(draws_cpu, same))
    pipe.compute_dtype = torch.bfloat16
    failed = []
    for name, a in g_card.items():
        a, b = a.cpu(), g_cpu[name]
        scale = float(b.abs().max())
        touched = (a != 0).any(dim=1) | (b != 0).any(dim=1)
        bad = ((a - b).abs() > GRAD_RTOL * b.abs() + GRAD_ATOL * scale).any(dim=1)
        rel_l2 = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
        share = float(bad.sum()) / max(1, int(touched.sum()))
        log(f"[compare] {name} gradient, card vs CPU, float32 MLPs: {int(bad.sum())} of "
            f"{int(touched.sum())} touched rows ({share:.3%}) outside rtol {GRAD_RTOL:g} + "
            f"{GRAD_ATOL:g} of max|g| {scale:.3g}; relative L2 error {rel_l2:.3g}; max abs "
            f"err {float((a - b).abs().max()):.3g}")
        if not (scale > 0 and share <= GRAD_BAD_ROWS and rel_l2 <= GRAD_REL_L2):
            failed.append(name)
    if failed:
        raise RuntimeError(f"card and CPU gradients disagree: {failed}")
    return counts


def main() -> int:
    name, smi = phase_device()
    sys.path.insert(0, str(REPO))
    phase_build()
    config = json.loads(CONFIG.read_text())
    ngp = config["pipeline"]["instant_ngp"]
    encodings = {"pos": ngp["encoding"], "surface": ngp["surface_encoding"]["nested"][0]}
    rows = phase_kernels(encodings)
    counts, ctx = phase_slice(smi)
    phase_profile(ctx, smi)
    phase_card_vs_cpu(ctx)
    train_counts = phase_train(ctx, smi, rows)
    for row in rows:
        kernel, d = row.pop("kernel"), row.pop("n_dims")
        row["launches_inference_path"] = counts[kernel][d]
        row["launches_training_path"] = train_counts[kernel][d]
        row["launches"] = counts[kernel][d] + train_counts[kernel][d]
        if row["launches"] == 0:
            raise RuntimeError(f"{row['name']} was never launched on a main path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
