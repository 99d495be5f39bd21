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
3. Kernels: K1 (the q8 hash gather) against its plain PyTorch version on the
   card, deterministic and with stochastic-rounding noise, at the flagship's
   shapes (3-D pos grid at M = 196,608; 2-D surface grid at M = 8,192).
   Tolerance: max abs error <= 1e-6 * max|output|. Times each (median of CUDA
   event timings after warm-up) beside its bound.
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

The launch counts of the main path (phases 4 and 5) are reset just before it
and read just after it. The second-to-last line is a JSON object with one
entry per kernel; the last line is the result, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
KERNEL_SOURCE = "atmonr_tpu_torch/csrc/hash_gather.cu"
KERNEL_REPLACES = "atmonr_tpu/ops/hash_gather_pallas.py:404"


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
    path, report = _build.build("hash_gather", verbose=True)
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(encodings: dict) -> list[dict]:
    """K1 against its plain version at the flagship shapes."""
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
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES, "n_dims": n_dims,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
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
    pipe(batches[5])
    pipe.init_aux()
    torch.cuda.synchronize()

    # ---- the main path: counts reset just before, read just after ----
    for d in hgo.hash_gather_q8.launches:
        hgo.hash_gather_q8.launches[d] = 0
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
    counts = dict(hgo.hash_gather_q8.launches)
    # ---- end of the main path ----

    n_batches = -(-N_EXTRACT // 32768)
    if sigma.shape != (N_EXTRACT, 1) or not np.all(np.isfinite(sigma)) or np.any(sigma < 0):
        raise RuntimeError("extraction result not finite, non-negative, (N, 1)")
    if counts != {3: 1 + 5 + n_batches, 2: 5}:
        raise RuntimeError(f"K1 launches on the main path: {counts}")
    steady = statistics.median(fwd_s[1:4])
    log(f"[slice] occupancy refresh ({pipe.occ_cfg.num_cells} cells): {refresh_s * 1e3:.2f} ms, "
        f"{pipe.occ_cfg.num_cells / refresh_s:.0f} cells/s on {card}")
    log(f"[slice] forward of {BATCH} rays (key=None, median of batches 2-4): "
        f"{steady * 1e3:.2f} ms = {BATCH / steady:.0f} rays/s on {card}; all five: "
        + ", ".join(f"{s * 1e3:.2f}" for s in fwd_s) + " ms")
    log(f"[extract] {N_EXTRACT} points in {n_batches} batches: {extract_s:.3f} s = "
        f"{N_EXTRACT / extract_s:.0f} points/s on {card}; sigma max {float(sigma.max()):.3g} m^-1")
    log(f"[slice] K1 launches on the main path: D=3 {counts[3]}, D=2 {counts[2]}")
    return counts, {"config": config, "ds": ds, "pipe": pipe, "batch": batches[0]}


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
    for label, fn, reps in (("forward", lambda: pipe(batch), 20), ("refresh", pipe.update_aux, 10)):
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
        kernels = [
            e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
        ]
        busy_us = sum(e.device_time_total for e in kernels)
        by_name: dict[str, list[float]] = {}
        for e in kernels:
            by_name.setdefault(e.name, []).append(e.device_time_total)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
        log(f"[profile] {label}: device busy {busy_us:.0f} us in {len(kernels)} kernels; "
            f"idle {1 - busy_us / (med * 1e6):.1%} of the unprofiled median call "
            f"({med * 1e6:.0f} us), {1 - busy_us / wall_us:.1%} of the profiled call "
            f"({wall_us:.0f} us), on {card}")
        for name, ts in top:
            log(f"[profile]   {sum(ts):8.1f} us  x{len(ts):<4d} {name[:90]}")


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
    for row in rows:
        row["launches"] = counts[row.pop("n_dims")]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
