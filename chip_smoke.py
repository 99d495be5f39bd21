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
   beside its bound. K1 (the hash gather) in its four table types, q8 (also
   with stochastic-rounding noise), bf16, f32 and f8: max abs error
   <= 1e-6 * max|output|; bf16 D=3 also over the 21,141,696-row table of
   ``configs/instant_ngp_occ21.json``, which does not fit the L2 cache (the
   bound counts of each level the rows that the points can need). K2
   (the hash-table gradient, float32 atomics, so not bit-reproducible): max
   abs error <= 1e-5 * max|dW| on uniform points; also with every point in
   one cell of the finest level, where all adds of a level contend for 2^D
   rows (<= 1e-4 * max|dW|). Each line ends with how the level plan
   (``atmonr_tpu_torch/ops/kernel_plan.py``) took the levels (staged in shared
   memory or direct), the shared memory and the blocks of the launch.
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
   cluster, and a row sums tens of thousands of terms in two orders; the
   kernel's run sums and block-wise partial sums change the order of a
   float32 sum that atomics already reorder), and
   compares one step's hash-table gradients on the card and on the CPU.
7. The other configurations, each unchanged at full width through
   ``Trainer.iterate`` at 8,192 rays per step, with finite losses and the
   launch counts its sampler implies (a count that differs raises):
   A ``instant_ngp_tpu_occ13_bf16.json`` (occupancy grid, ``fwd_mode`` auto =
   bf16): a refresh, 3 forwards, a short extraction, 64 steps, the loss
   falls, K1 q8 never runs; then card vs CPU on one batch.
   B ``instant_ngp_tpu_fast.json`` (importance sampler): 32 steps; K1 bf16
   D=3 twice per step (coarse pass without gradient, fine pass with).
   C ``instant_ngp_tpu.json`` (uniform sampler, 1,048,576 points per step):
   16 steps.
   D ``instant_ngp_occ21.json`` (2^21-entry pos table, 2^19 surface table):
   a refresh, a forward, 32 steps, the loss falls; K2 at the 169 MB
   gradient table on one forward's own points. Then ``instant_ngp.json``
   (uniform, 1,024 samples, ``micro_batch_size`` 1,024): 2 steps of 8
   micro-batches, one optimizer update each.
   f32 and f8: the flagship config with both grids' ``fwd_mode`` set to
   ``"f32"``, then ``"f8"``, in memory: a forward and 4 steps each; the f32
   encodings equal the ``"xla"`` ones bit for bit.
   Each prints its steady time per step, peak device memory and one
   profiled step. After A, B, C, D and ``instant_ngp.json``, K1 bf16 and K2
   are held to their plain versions at the shapes that path gives them: the
   pos grid on one forward's own sample points over the trained table (up
   to 1,048,576 points into 21,141,696 rows; B's coarse pass too), the
   surface grid on the batch's surface points (K1 <= 1e-6 * max|out|, K2
   <= 1e-4 * max|dW|).

Each main path (phases 4-5, phase 6, and each configuration of phase 7) has
every launch count set to 0 just before it and read just after it. The
second-to-last line is a JSON object with one entry per kernel; the last
line is the result, ``{"ok": true, "device": ...}``.
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
CONFIGS = REPO / "configs"
CONFIG = CONFIGS / "instant_ngp_tpu_occ13.json"
SCENE = "synthetic:128x64x2"
# the 2^21 configs: 36 steps per epoch, so a short run writes one checkpoint
# (parameters and AdamW moments of a 169 MB table are 0.5 GB a checkpoint)
SCENE_BIG = "synthetic:256x144x2"
BATCH = 8192
N_EXTRACT = 1 << 20
# H100 SXM published peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
K1_SOURCE = "atmonr_tpu_torch/csrc/hash_gather.cu"
K1_REPLACES = "atmonr_tpu/ops/hash_gather_pallas.py:404"
K1_MODES = ("q8", "bf16", "f32", "f8")
K1_ROW_BYTES = {"q8": 2, "bf16": 4, "f32": 8, "f8": 2}
K1_NO_LIBRARY = "no single PyTorch call computes a multi-level hashed gather"
K1_TOL = 1e-6  # of max|out|: the kernel rounds each op as the plain version does
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


def k1_bound(m: int, cfg, mode: str = "q8") -> tuple[float, str]:
    """Least time for K1 on (m, D) points: each input read once and each
    output written once over the memory rate, against its float32
    operations (5D per point and level for the cell math, D+4 per corner for
    the weight and the two features' multiply-add and conversion, and 2 for
    the scale) over the float32 peak. Of the table (rows of ``mode``'s
    width) it counts what m points can need: per level the smaller of its
    rows and the m * 2^D gathers."""
    d, n_levels = cfg.n_dims, cfg.n_levels
    rows = sum(min(size, m << d) for size in cfg.level_sizes)
    n_bytes = (m * d * 4 + m * cfg.n_output_dims * 4
               + rows * K1_ROW_BYTES[mode] + n_levels * 4)
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
    from atmonr_tpu_torch.ops.hash_gather import hash_gather

    for counts in (hash_gather.launches, hash_bwd.launches):
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    """Every launch count, keyed as the kernel rows are: ("K1", mode, D)
    and ("K2", None, D)."""
    from atmonr_tpu_torch.ops.hash_bwd import hash_bwd
    from atmonr_tpu_torch.ops.hash_gather import hash_gather

    counts = {("K1", mode, d): n for (mode, d), n in hash_gather.launches.items()}
    counts.update({("K2", None, d): n for d, n in hash_bwd.launches.items()})
    return counts


def launched(counts: dict) -> dict:
    """The counts that are not 0."""
    return {k: n for k, n in counts.items() if n}


def show(counts: dict) -> str:
    return ", ".join(
        f"{k[0]}{' ' + k[1] if k[1] else ''} D={k[2]} x{n}" for k, n in sorted(
            launched(counts).items(), key=lambda kv: (kv[0][0], str(kv[0][1]), -kv[0][2]))
    ) or "none"


def step_counts(mode: str, steps: int, k1_d3_extra: int = 0, k1_d2_extra: int = 0,
                k1_d3_per_step: int = 1) -> dict:
    """The launches of ``steps`` train steps in ``mode``: K1 and K2 once per
    grid per step (K1 D=3 ``k1_d3_per_step`` times), plus K1 launches
    outside the backward (refreshes, forwards, extraction batches)."""
    want = {
        ("K1", mode, 3): k1_d3_per_step * steps + k1_d3_extra,
        ("K1", mode, 2): steps + k1_d2_extra,
        ("K2", None, 3): steps,
        ("K2", None, 2): steps,
    }
    return launched(want)


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
    from atmonr_tpu_torch.ops.kernel_plan import level_plan
    from atmonr_tpu_torch.utils.timing import graph_ms, median_ms

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
        f"({bound_by}; {atomics / 1e6:.1f} M corner adds), library ms null: {K2_NO_LIBRARY}; "
        + level_plan(cfg, x.shape[0], hbo.ACC_BYTES, True).describe())
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_k1(mode: str, label: str, cfg, table, x, noise=None, reps: int = 50) -> dict:
    """K1 in ``mode`` against its plain version on (table, x): raises unless
    the largest difference is within ``K1_TOL * max|out|`` (for q8 also with
    stochastic-rounding ``noise``); returns the error and the times (device
    ms by graph replay; per call with the host launch; plain)."""
    from atmonr_tpu_torch.ops import hash_gather as hgo
    from atmonr_tpu_torch.ops.kernel_plan import level_plan
    from atmonr_tpu_torch.utils.timing import graph_ms, median_ms

    d, m = cfg.n_dims, x.shape[0]
    err = 0.0
    for u in ((None, noise) if mode == "q8" else (None,)):
        prepared, scales = hgo.prepare_table(table, cfg, mode, u)
        before = hgo.hash_gather.launches[(mode, d)]
        got = hgo.hash_gather(prepared, scales, x, cfg)
        torch.cuda.synchronize()
        if hgo.hash_gather.launches[(mode, d)] != before + 1:
            raise RuntimeError("K1 launch counter did not move")
        want = hgo.hash_gather_plain(prepared, scales, x, cfg)
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not (got.shape == want.shape and torch.isfinite(got).all() and scale > 0
                and diff <= K1_TOL * scale):
            raise RuntimeError(f"K1 {mode} {label} disagrees: max abs err {diff} vs max|out| {scale}")
        err = max(err, diff)
    call_ms = median_ms(lambda: hgo.hash_gather(prepared, scales, x, cfg), reps=reps, warmup=10)
    ms = graph_ms(lambda: hgo.hash_gather(prepared, scales, x, cfg))
    plain_ms = median_ms(lambda: hgo.hash_gather_plain(prepared, scales, x, cfg), reps=10)
    bound_ms, bound_by = k1_bound(m, cfg, mode)
    log(f"[kernel] K1 {mode} {label} D={d} M={m} T={cfg.total_params}: max abs err {err:.3g} "
        f"(tolerance {K1_TOL:g} * max|out|), device {ms:.4f} ms, per call with launch "
        f"{call_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"library ms null: {K1_NO_LIBRARY}; "
        + level_plan(cfg, m, hgo.ROW_BYTES[mode], False).describe())
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels(encodings: dict, big_encoding: dict) -> list[dict]:
    """K1 (four table types) and K2 against their plain versions at the
    flagship shapes, on uniform random points; K1 bf16 D=3 also over the
    2^21-entry table of ``big_encoding``."""
    from atmonr_tpu_torch.models import hash_grid as hg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for label, n_dims, m in (("pos", 3, 196_608), ("surface", 2, 8_192)):
        cfg = hg.HashGridConfig.from_options(encodings[label], n_dims)
        table = torch.rand((cfg.total_params, 2), generator=gen, device=dev) * 2e-4 - 1e-4
        noise = torch.rand(table.shape, generator=gen, device=dev)
        x = torch.rand((m, n_dims), generator=gen, device=dev)
        for mode in K1_MODES:
            k1 = check_k1(mode, label, cfg, table, x, noise)
            rows.append({
                "name": f"hash_gather {mode} D={n_dims} ({label} grid)", "route": "cuda",
                "source": K1_SOURCE, "replaces": K1_REPLACES, "key": ("K1", mode, n_dims),
                "launches": 0, "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
                "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
                "bound_by": k1["bound_by"], "library_ms": None,
            })
        g = torch.randn((m, cfg.n_output_dims), generator=gen, device=dev)
        k2 = check_k2(x, g, cfg, 1e-5, f"{label}, uniform points,")
        rows.append({
            "name": f"hash_bwd D={n_dims} ({label} grid)", "route": "cuda",
            "source": K2_SOURCE, "replaces": K2_REPLACES, "key": ("K2", None, n_dims),
            "launches": 0, "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
            "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"], "library_ms": None,
        })
        if n_dims == 3:
            # every point in one cell of the finest level: all adds of a level
            # contend for its 2^D rows, the worst a staged level can see
            cell = 1.0 / cfg.level_scales[-1]
            x_cell = 0.37 + 0.9 * cell * torch.rand((m, n_dims), generator=gen, device=dev)
            check_k2(x_cell, g, cfg, 1e-4, f"{label}, all points in one cell of the finest level,")
        del table, noise, x, g

    # bf16 over a table that leaves the L2 cache: every gather is a sector
    # from device memory
    cfg = hg.HashGridConfig.from_options(big_encoding, 3)
    m = 196_608
    table = torch.rand((cfg.total_params, 2), generator=gen, device=dev) * 2e-4 - 1e-4
    x = torch.rand((m, 3), generator=gen, device=dev)
    big = check_k1("bf16", "pos 2^21", cfg, table, x, reps=20)
    sectors = m * cfg.n_levels * 8
    log(f"[kernel] K1 bf16 pos 2^21: the {cfg.total_params * 4 / 1e6:.1f} MB table exceeds the "
        f"50 MB L2; {sectors / 1e6:.1f} M gathers of one 32-byte sector each are "
        f"{sectors * 32 / 1e6:.0f} MB = {1e3 * sectors * 32 / PEAK_BYTES_S:.4f} ms at the memory "
        "rate, beside the bound above, which reads each level's rows once, or one row per "
        "gather where a level has more rows than gathers")
    row = next(r for r in rows if r["key"] == ("K1", "bf16", 3))
    row.update(ms_2p21_table=big["ms"], plain_ms_2p21_table=big["plain_ms"],
               bound_ms_2p21_table=big["bound_ms"],
               max_abs_err=max(row["max_abs_err"], big["max_abs_err"]))
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
    if hgo.hash_gather.launches[("q8", 3)] != 1:
        raise RuntimeError("occupancy refresh did not launch K1 once")
    fwd_s = []
    for i in range(5):
        before = dict(hgo.hash_gather.launches)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = pipe(batches[i], generator=gen if i == 4 else None)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        _check_render(out, BATCH, n_fine)
        after = hgo.hash_gather.launches
        if any(after[("q8", d)] != before[("q8", d)] + 1 for d in (3, 2)):
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
    counts = read_counts()
    # ---- end of the main path ----

    n_batches = -(-N_EXTRACT // 32768)
    if sigma.shape != (N_EXTRACT, 1) or not np.all(np.isfinite(sigma)) or np.any(sigma < 0):
        raise RuntimeError("extraction result not finite, non-negative, (N, 1)")
    if launched(counts) != {("K1", "q8", 3): 1 + 5 + n_batches, ("K1", "q8", 2): 5}:
        raise RuntimeError(f"launches on the inference path: {show(counts)}")
    steady = statistics.median(fwd_s[1:4])
    log(f"[slice] occupancy refresh ({pipe.occ_cfg.num_cells} cells): {refresh_s * 1e3:.2f} ms, "
        f"{pipe.occ_cfg.num_cells / refresh_s:.0f} cells/s on {card}")
    log(f"[slice] forward of {BATCH} rays (key=None, median of batches 2-4): "
        f"{steady * 1e3:.2f} ms = {BATCH / steady:.0f} rays/s on {card}; all five: "
        + ", ".join(f"{s * 1e3:.2f}" for s in fwd_s) + " ms")
    log(f"[extract] {N_EXTRACT} points in {n_batches} batches: {extract_s:.3f} s = "
        f"{N_EXTRACT / extract_s:.0f} points/s on {card}; sigma max {float(sigma.max()):.3g} m^-1")
    log(f"[slice] launches on the inference path: {show(counts)}; K2 none")
    return counts, {"config": config, "ds": ds, "pipe": pipe, "batch": batches[0]}


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


def phase_card_vs_cpu(ctx: dict, share_preprocessor: bool = False) -> None:
    """One batch on the card and on the CPU, float32 MLP products on both.
    ``share_preprocessor`` gives the CPU pipeline the card's preprocessed
    points, for a trained model: the float32 altitude solve differs by ~1e-4
    between the devices (see GRAD_REL_L2 above), which a trained field's
    finest cells turn into a visible difference of color.

    Tolerance: rtol 1e-4 plus 1e-6 of each output's largest value, on the
    rendered color, the surface color and the sample placement. The
    samplers are discontinuous and float32 sin/cos/arctan2 differ by ulps
    between the card and the CPU, so up to 1% of the rays may take other
    samples; every other ray must agree."""
    from atmonr_tpu_torch import get_pipeline

    pipe, batch = ctx["pipe"], ctx["batch"]
    cpu = get_pipeline(ctx["config"]["pipeline"], ctx["ds"], device="cpu")
    cpu.load_state_dict(pipe.state_dict())
    if share_preprocessor:
        # how far the two devices' float32 preprocessors are apart on this
        # batch's own sample points, per output coordinate
        with torch.no_grad():
            pts = pipe._sample(batch, {})[0]
            apart = (pipe.point_preprocessor(pts).cpu() - cpu.point_preprocessor(pts.cpu())).abs()
        log("[compare] card vs CPU preprocessor on the batch's sample points, max |difference| "
            "per coordinate of the normalized output: "
            + ", ".join(f"{v:.3g}" for v in apart.reshape(-1, apart.shape[-1]).amax(dim=0).tolist()))
        cpu.point_preprocessor = lambda pts: pipe.point_preprocessor(pts.to(pipe.device)).cpu()
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
        torch.cuda.reset_peak_memory_stats()
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
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
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
        f"{trainer.epoch_idx} epochs, {n_ckpt} checkpoints; peak device memory "
        f"{peak_mib:.0f} MiB")
    if not last < first:
        raise RuntimeError(f"the loss did not fall: {first} -> {last}")
    want = step_counts("q8", TRAIN_STEPS, k1_d3_extra=TRAIN_STEPS // every)
    if launched(counts) != want:
        raise RuntimeError(f"launches on the training path: {show(counts)}, expected {show(want)}")
    log(f"[train] launches on the training path (K1 D=3 once per step and per refresh): "
        f"{show(counts)}")
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
    if {k: after[k] - before[k] for k in after if after[k] != before[k]} != step_counts("q8", 1):
        raise RuntimeError(f"the profiled step's launches: {show(before)} -> {show(after)}")
    log_profile(prof, "train step (no refresh)", med * 1e6, wall_us, card, top=10)

    # K2 on one forward's own sample points of the trained model: they
    # cluster where the occupancy grid sends them, and contend
    batch = batching.gather_batch(trainer.rays, idx[1])
    draws = pipe.make_draws(BATCH, trainer.generators["draws"])
    x, _ = pipe.sample_points(batch, draws)
    g = torch.randn((x.shape[0], pipe.pos_cfg.n_output_dims), device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(11))
    own = check_k2(x, g, pipe.pos_cfg, 1e-4, "pos, one forward's own sample points,")
    row = next(r for r in rows if r["key"] == ("K2", None, 3))
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


def steady_step_s(trainer, n_blocks: int, block: int) -> list[float]:
    """Seconds per step of ``n_blocks`` blocks of ``block`` ``Trainer.step``
    calls on fresh batches, each block ending in a synchronize (no epoch
    end inside)."""
    from atmonr_tpu_torch.data import batching

    b = trainer.batch_size
    perm = batching.epoch_permutation(trainer.generators["perm"], trainer.num_rays, b)
    idx = [perm[i * b:(i + 1) * b] for i in range(trainer.steps_per_epoch)]
    out = []
    for k in range(n_blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(block):
            trainer.step(idx[(k * block + i) % len(idx)])
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / block)
    return out


def run_config(tag: str, config: dict, ds, card: str, *, steps: int, mode: str = "bf16",
               refresh: bool = False, n_forwards: int = 0, extract_points: int = 0,
               must_fall: bool = False, steady: tuple[int, int] = (2, 8)) -> dict:
    """One configuration's main path at full width: an occupancy refresh,
    ``n_forwards`` renders of 8,192 rays, an extraction of ``extract_points``
    points (each where asked), then ``steps`` steps of ``Trainer.iterate``,
    with every launch count set to 0 just before and read just after, and
    held to what the config's sampler and ``mode`` imply. Then steady step
    times and one profiled step. Returns the counts and the objects."""
    from atmonr_tpu_torch import Trainer, get_pipeline, run_extraction
    from torch.profiler import ProfilerActivity, profile

    pcfg = config["pipeline"]
    pipe = get_pipeline(pcfg, ds)
    tcfg = dict(config["trainer"], num_iters=steps)
    rays = ds.rays()
    batches = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in rays.items()} for i in range(3)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    occ, imp = pipe.occ_cfg, pipe.importance
    n = occ.n_fine if occ else sum(imp) if imp else int(pcfg["num_samples_per_ray"])
    k1_d3 = 2 if imp and not occ else 1  # the importance sampler's coarse pass
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(tcfg, ds, pipe, f"chip_smoke_{tag}", data_root=root, seed=0)
        n_micro = BATCH // trainer.micro_batch if trainer.micro_batch else 1
        if trainer.batch_size != BATCH:
            raise RuntimeError(f"batch size {trainer.batch_size}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        t0 = time.perf_counter()
        if refresh:
            pipe.update_aux(generator=gen)
        for i in range(n_forwards):
            with torch.no_grad():
                out = pipe(batches[i], generator=gen if i == n_forwards - 1 and i else None)
            _check_render(out, BATCH, n)
        n_batches = 0
        if extract_points:
            host = ds.host_rays()
            rng = np.random.default_rng(0)
            idx = rng.integers(0, len(ds), extract_points)
            t = rng.uniform(0.0, 1.0, extract_points) * host["len"][idx]
            pts = host["origin"][idx].astype(np.float64) + host["dir"][idx] * t[:, None]
            sigma = run_extraction(pipe, pts * ds.scale + ds.offset[None], batch_size=32768)
            n_batches = -(-extract_points // 32768)
            if (sigma.shape != (extract_points, 1) or not np.all(np.isfinite(sigma))
                    or np.any(sigma < 0)):
                raise RuntimeError(f"[{tag}] extraction result not finite, non-negative, (N, 1)")
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        losses = []
        t_first = None
        for _ in trainer.iterate(Path(root) / "output"):
            losses.append(trainer.last_loss)
            if t_first is None:
                torch.cuda.synchronize()
                t_first = time.perf_counter()
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t_first
        counts = read_counts()
        # ---- end of the main path ----
        peak_mib = torch.cuda.max_memory_allocated() / 2**20

    loss = torch.stack(losses).cpu()
    if trainer.iter_count != steps or loss.shape != (steps,) or trainer.optimizer.count != steps:
        raise RuntimeError(f"[{tag}] ran {trainer.iter_count} steps, {trainer.optimizer.count} "
                           f"optimizer updates, {loss.shape} losses")
    if not bool(torch.isfinite(loss).all()):
        raise RuntimeError(f"[{tag}] a training loss is not finite")
    k = max(1, steps // 4)
    first, last = float(loss[:k].mean()), float(loss[-k:].mean())
    if must_fall and not last < first:
        raise RuntimeError(f"[{tag}] the loss did not fall: {first} -> {last}")
    refreshes = steps // occ.update_every if occ else 0
    want = step_counts(
        mode, steps * n_micro, k1_d3_per_step=k1_d3,
        k1_d3_extra=int(refresh) + n_forwards * k1_d3 + n_batches + refreshes,
        k1_d2_extra=n_forwards,
    )
    if launched(counts) != want:
        raise RuntimeError(f"[{tag}] launches: {show(counts)}; expected {show(want)}")
    sampler = "occupancy" if occ else "importance" if imp else "uniform"
    log(f"[{tag}] {sampler} sampler, {n} samples per ray = {BATCH * n} points per step, "
        f"{n_micro} micro-batch(es), pos table {pipe.pos_cfg.total_params} rows; inference part "
        f"(refresh {int(refresh)}, forwards {n_forwards}, extraction {extract_points} points) "
        f"{infer_s * 1e3:.1f} ms; {steps} steps through Trainer.iterate: loss first {k} "
        f"{first:.4f}, last {k} {last:.4f}; steps 2-{steps} with epoch ends "
        f"{1e3 * rest_s / max(1, steps - 1):.2f} ms per step; peak device memory "
        f"{peak_mib:.0f} MiB, on {card}")
    log(f"[{tag}] launches on the path: {show(counts)}")

    per = steady_step_s(trainer, *steady)
    med = statistics.median(per)
    log(f"[steady] {tag} train step of {BATCH} rays (median of {steady[0]} blocks of "
        f"{steady[1]} steps): {med * 1e3:.2f} ms = {BATCH / med:.0f} rays/s, min "
        f"{min(per) * 1e3:.2f}, max {max(per) * 1e3:.2f} ms, on {card}")
    before = read_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(torch.arange(BATCH, device=pipe.device))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    after = read_counts()
    log(f"[profile] {tag} step launches: "
        + show({key: after[key] - before[key] for key in after}))
    log_profile(prof, f"{tag} train step", med * 1e6, wall_us, card, top=6)
    return {"counts": counts, "config": config, "ds": ds, "pipe": pipe, "trainer": trainer,
            "batch": batches[0]}


def check_path_kernels(tag: str, pipe, batch: dict, rows: list[dict]) -> dict:
    """K1 (in the pipeline's mode) and K2 against their plain versions at
    the shapes this path gives them: the pos grid on one forward's own
    sample points over the trained table (with the importance sampler also
    its coarse pass's points, which K2 never sees), the surface grid on the
    batch's own surface points. K1 within ``K1_TOL * max|out|``; K2 within
    1e-4 * max|dW| (the points cluster). Each result goes into its kernel's
    row; returns them by (grid, kernel)."""
    from atmonr_tpu_torch.models import hash_grid as hg
    from atmonr_tpu_torch.ops.samplers import sample_uniform_bins

    dev = pipe.device
    b = batch["origin"].shape[0]
    draws = pipe.make_draws(b, torch.Generator(device=dev).manual_seed(13))
    with torch.no_grad():
        x, _ = pipe.sample_points(batch, draws)
        sets = [("pos", pipe.pos_cfg, pipe.pos_table.detach(), x, True)]
        if pipe.importance and pipe.occ_cfg is None:
            pts_c, _ = sample_uniform_bins(batch, pipe.importance[0], draws["coarse"])
            x_c = pipe._encoder_inputs(pts_c).reshape(-1, 3).contiguous()
            sets.append(("pos coarse", pipe.pos_cfg, pipe.pos_table.detach(), x_c, False))
        surf = (batch["origin"] + batch["dir"] * batch["len"][:, None] + 1.0) / 2.0
        sets.append(("surface", pipe.surf_cfgs[0], pipe.surf_enc["0"].detach(),
                     surf[:, :2].contiguous(), True))
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for label, cfg, table, pts, with_k2 in sets:
        mode = hg.resolve_fwd_mode(cfg)
        res = {("K1", mode, cfg.n_dims): check_k1(mode, f"{tag} {label}", cfg, table, pts, reps=20)}
        if with_k2:
            g = torch.randn((pts.shape[0], cfg.n_output_dims), device=dev, generator=gen)
            res["K2", None, cfg.n_dims] = check_k2(
                pts, g, cfg, 1e-4, f"{tag} {label}, the path's own points,")
        for key, r in res.items():
            row = next(r_ for r_ in rows if r_["key"] == key)
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
            row.setdefault("at_path_shapes", []).append({
                "path": tag, "grid": label, "m": pts.shape[0], "table_rows": cfg.total_params,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"]})
            out[label, key[0]] = r
    return out


def phase_configs(flagship: dict, card: str, rows: list[dict]) -> dict:
    """Phase 7: the other configurations. Returns the launch counts of each
    path's window, by path name."""
    import copy

    from atmonr_tpu_torch import get_dataset, load_config
    from atmonr_tpu_torch.models import hash_grid as hg

    ds = flagship["ds"]
    paths = {}

    # A: the flagship's structure with fwd_mode auto = bf16
    a = run_config("A occ13_bf16", load_config(CONFIGS / "instant_ngp_tpu_occ13_bf16.json"), ds,
                   card, steps=64, refresh=True, n_forwards=3, extract_points=131072,
                   must_fall=True, steady=(8, BLOCK))
    if any(n for k, n in a["counts"].items() if k[1] == "q8"):
        raise RuntimeError("path A launched the q8 kernel")
    check_path_kernels("A occ13_bf16", a["pipe"], a["batch"], rows)
    phase_card_vs_cpu(a, share_preprocessor=True)
    paths["A"] = a["counts"]
    del a
    torch.cuda.empty_cache()

    # B: importance sampler; C: uniform sampler
    for tag, name, steps, steady in (("B tpu_fast", "instant_ngp_tpu_fast.json", 32, (2, 8)),
                                     ("C tpu", "instant_ngp_tpu.json", 16, (2, 4))):
        r = run_config(tag, load_config(CONFIGS / name), ds, card, steps=steps, steady=steady)
        check_path_kernels(tag, r["pipe"], r["batch"], rows)
        paths[tag[0]] = r["counts"]
        del r
        torch.cuda.empty_cache()

    # D: the 2^21 reference tables
    t0 = time.perf_counter()
    config = load_config(CONFIGS / "instant_ngp_occ21.json")
    big = get_dataset(config["dataset"], SCENE_BIG)
    log(f"[D] {SCENE_BIG}: {len(big)} rays in {time.perf_counter() - t0:.2f} s (set-up)")
    d = run_config("D occ21", config, big, card, steps=32, refresh=True, n_forwards=1,
                   must_fall=True, steady=(2, BLOCK))
    own = check_path_kernels("D occ21", d["pipe"], d["batch"], rows)["pos", "K2"]
    row = next(r for r in rows if r["key"] == ("K2", None, 3))
    row.update(ms_2p21_table=own["ms"], plain_ms_2p21_table=own["plain_ms"],
               bound_ms_2p21_table=own["bound_ms"],
               max_abs_err_2p21_table=own["max_abs_err"])
    paths["D"] = d["counts"]
    del d
    torch.cuda.empty_cache()
    r = run_config("D instant_ngp", load_config(CONFIGS / "instant_ngp.json"), big, card,
                   steps=2, steady=(1, 2))
    micro = r["trainer"].micro_batch
    if micro != BATCH // 8:
        raise RuntimeError(f"micro-batch {micro}, expected {BATCH // 8}")
    # the kernels see one micro-batch at a time: 1,024 rays of 1,024 samples
    check_path_kernels("D instant_ngp", r["pipe"], {k: v[:micro] for k, v in r["batch"].items()},
                       rows)
    paths["D micro"] = r["counts"]
    del r, big
    torch.cuda.empty_cache()

    # f32 and f8: the flagship config with both grids' mode set in memory
    for mode in ("f32", "f8"):
        config = copy.deepcopy(flagship["config"])
        ngp = config["pipeline"]["instant_ngp"]
        ngp["encoding"]["fwd_mode"] = mode
        ngp["surface_encoding"]["nested"][0]["fwd_mode"] = mode
        r = run_config(f"flagship {mode}", config, ds, card, steps=4, mode=mode, n_forwards=1,
                       steady=(2, BLOCK))
        if mode == "f32":
            pipe = r["pipe"]
            with torch.no_grad():
                x, _ = pipe.sample_points(r["batch"])
                x2 = torch.rand((BATCH, 2), device=x.device)
                for table, cfg, pts in ((pipe.pos_table, pipe.pos_cfg, x),
                                        (pipe.surf_enc["0"], pipe.surf_cfgs[0], x2)):
                    exact = hg.HashGridConfig.from_options(
                        {**{f: getattr(cfg, f) for f in (
                            "n_levels", "n_features_per_level", "log2_hashmap_size",
                            "base_resolution", "per_level_scale")}, "fwd_mode": "xla"},
                        cfg.n_dims)
                    if not torch.equal(hg.hash_encode(table, pts, cfg),
                                       hg.hash_encode(table, pts, exact)):
                        raise RuntimeError(f"f32 kernel encodings differ from 'xla', D={cfg.n_dims}")
            log("[flagship f32] the f32 kernel's encodings equal the 'xla' gather's bit for bit "
                f"(pos grid at {x.shape[0]} sample points, surface grid at {BATCH} points)")
        paths[mode] = r["counts"]
        del r
        torch.cuda.empty_cache()
    return paths


def main() -> int:
    name, smi = phase_device()
    sys.path.insert(0, str(REPO))
    phase_build()
    config = json.loads(CONFIG.read_text())
    ngp = config["pipeline"]["instant_ngp"]
    encodings = {"pos": ngp["encoding"], "surface": ngp["surface_encoding"]["nested"][0]}
    big = json.loads((CONFIGS / "instant_ngp_occ21.json").read_text())
    rows = phase_kernels(encodings, big["pipeline"]["instant_ngp"]["encoding"])
    counts, ctx = phase_slice(smi)
    phase_profile(ctx, smi)
    phase_card_vs_cpu(ctx)
    paths = {"flagship inference": counts, "flagship training": phase_train(ctx, smi, rows)}
    paths.update(phase_configs(ctx, smi, rows))
    for row in rows:
        key = row.pop("key")
        row["launches_by_path"] = {path: c[key] for path, c in paths.items() if c[key]}
        row["launches"] = sum(row["launches_by_path"].values())
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
