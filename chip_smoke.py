#!/usr/bin/env python3
"""Smoke run of atmonr_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. Build: compiles every CUDA kernel of the port from ``atmonr_tpu_torch/csrc``
   (``nvcc`` for sm_90a, into ``atmonr_tpu_torch/_build``) and, at the same
   time, the host library ``csrc/atmonr_native.cpp`` (``g++`` with OpenMP,
   which builds the rays and walks the global grid's voxels); prints the
   build times, ``ptxas``'s register report and OpenMP's thread count.
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
   memory or direct), the shared memory and the blocks of the launch. K1p
   (the q8/f8 table preparation, ``csrc/quantize.cu``) at both flagship
   tables and a 2^14 position table, q8 with and without stochastic-rounding
   noise and f8: codes and scales equal to its plain version's bit for bit,
   its device ms and the plain version's (graph replay) beside its bound and
   its launch floor (an empty kernel in its grid and cluster shape). K1p's
   bf16 instance (``round_bf16_kernel``, the bf16 table's rounding) at both
   flagship tables and the 2^21 position table: equal to
   ``table.to(torch.bfloat16)`` on the card bit for bit, its device ms and
   the cast's (graph replay) beside its bound.
4. Slice: loads ``configs/instant_ngp_tpu_occ13.json`` unchanged, builds a
   ``synthetic:128x64x2`` granule and the pipeline on the card (random
   weights from seed 0), refreshes the occupancy grid once, renders 4 batches
   of 8,192 rays deterministically and 1 with a generator, and checks the
   outputs and that K1 ran for both grids on every forward. Then renders one
   batch on the card and on the CPU with float32 MLP products and compares.
   Profiles one forward and one refresh (device time by kernel; idle share of
   the unprofiled median call).
5. Extraction: ``run_extraction`` over 1,048,576 points along the granule's
   rays, in 32,768-point batches: its graph counters, ``staged_batches``
   (held to the call's batches: each went through the pinned ring) and the
   call's device peak.
6. Train: ``Trainer`` on the same config and granule at full width, 8,192
   rays per step, 192 steps (past ``restart_on_plateau.check_iter`` = 150,
   12 occupancy refreshes, epoch ends with metrics, the RGB comparison image
   and asynchronous checkpoints). Checks that every loss is finite, that the
   loss fell, that the epoch image (surface | atmosphere | full | target)
   equals the one assembled on the host from the three progress buffers, and
   that K1 (with K1p, which prepares its q8 table) and K2 ran once per grid
   per step (K1 once more per refresh). Then times 16-step
   blocks of steady steps, profiles one step (a line with its launches, its
   largest device ops, K1p's time and every kernel left that scatters; K1p
   must be its one clustered kernel, launched once for each of the two
   tables),
   holds K2 to its plain
   version on one forward's own sample points (<= 1e-4 * max|dW|: they
   cluster, and a row sums tens of thousands of terms in two orders; the
   kernel's run sums and block-wise partial sums change the order of a
   float32 sum that atomics already reorder), and
   compares one step's hash-table gradients on the card and on the CPU.
   Extract: the trained flagship saved as the train CLI leaves an
   experiment (``args.json``, ``config.json``, a checkpoint) and restored
   from it (``restore_params``), then three grids of the same granule,
   queried in the extract CLI's 32,768-point batches: ``l1c`` (the
   pseudo-L1C of the synthetic granule at a 25 m ladder, 128 x 64 x 801 =
   6,561,792 points) and ``voxelgrid`` (the CLI's 3 km / 250 m; no DEM, so
   zero heights with a warning) through ``get_extract_dataset`` and
   ``run_extraction``, ``globalgrid`` through the whole extract CLI
   (``main``) at its defaults, which writes the ``.npy`` pair (no OpenVDB
   here); the global grid is built once more with the numpy walk, timed
   beside the CLI's (the host library's walk writing int64 keys) and equal
   to it. Each ``[extract <grid>]`` line gives the points, the host seconds
   of the grid build, points/s over the whole ``run_extraction`` (both
   copies included), K1's launches against ceil(N / 32,768) (a count that
   differs raises; on the card ``run_extraction`` replays a CUDA graph for
   each full batch after the first and adds the launches its capture
   recorded at each replay, so these counts include replays that the runner
   counts: ``run_extraction.graph_batches`` is held to the full batches
   after the first, and a profiled voxelgrid query's K1 and K1p counts to
   the kernels its trace saw) and peak device memory; each ``[compare] extract
   <grid>`` line 16,384 of its points (seed 0) on the card and on the CPU,
   float32 MLPs and one preprocessor, at most 1% of rows outside rtol
   1e-4 + 1e-6 of max|sigma|, and the main run's bfloat16 sigma against the
   CPU's with its own preprocessor (printed, no limit). K1 q8 is also held
   to its plain version at the first l1c batch's own points. ``[orbit]``:
   60 frames of the l1c volume, laid out as ``make_video`` reads the
   extract, at 640x480 with 192 samples a ray, in ms a frame; one frame
   (at 160x120) against the CPU's, max |brightness difference| <= 1e-4. The netCDF
   writers and the L1C, DEM and EarthCARE readers need h5py, which the
   card's machine lacks: the phase says so on a line of its own and does
   not call them.
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
   the dataset's set-up with the host library's ray builder and with the
   numpy one (rays within 25 m; every phase uses the library's), a refresh,
   a forward, 32 steps, the loss falls; a synchronous and two asynchronous
   checkpoints of the 0.5 GB state, timed, with steps during the writes, each
   reloaded equal to the state at its save; K2 at the 169 MB gradient table
   on one forward's own points. Then ``instant_ngp.json``
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

   After D, the pair-bucket configs (``hashed_tile: "on"``; the position
   grid takes the exact gather over the bf16 table, no kernel):
   ``instant_ngp_occ21_pb.json`` on D's granule, a refresh, a forward, 32
   steps, the loss falls, card vs CPU on one forward, K1 bf16 D=2 and K2 D=2
   once per step and no D=3 launch; then ``instant_ngp_pb.json``, 2 steps
   of 8 micro-batches.
8. NeRF: ``configs/nerf.json`` unchanged at full width (4,096 rays, 64 + 128
   samples, ``L_x`` [14, 14, 10], ``L_d`` 4, 256 wide) on the flagship's
   granule, seed-0 weights: 512 rays rendered deterministically on the card
   and on the CPU (one preprocessor; at most 1% of rays outside rtol 1e-4 +
   1e-6 of max in the coarse pass and the fine depths, and in the fine pass
   at the card's fine samples; ``nerf_card_vs_cpu`` says why), 3 forwards, 48 steps of ``Trainer.iterate`` (finite losses,
   the last quarter's mean below the first's), a voxel-grid extraction of
   (N, 4) sigma, steady ms per step and rays/s beside the step's float32
   GEMM bound, one profiled step with its GEMM share, peak memory; no K1 or
   K2 launch. Then ``include_height`` (no preprocessor, set in memory) for
   ``nerf.json`` (``L_x`` gains a 4th entry of 10) and for
   ``instant_ngp_tpu.json`` (a 4-D position grid, no D=3 launch), 8 steps
   each with finite losses.
9. Multi-device, in an NCCL process group of one rank (``FileStore`` in a
   temporary directory; the machine has one card and NCCL refuses two
   ranks on it): the flagship's ``Trainer.shard`` on ``data=1``, 4 steps on
   the same rays and draws as the unsharded Trainer (losses to rtol 1e-5,
   hash tables within ``MULTI_TABLE_REL_L2``, the same launches a step),
   4 blocks of 16 steady steps of each in turns, a profiled step and the
   gradient all-reduce alone; two granules of the flagship's scene through
   ``train_granules`` on the card, 32 steps each (losses fall, twice a lone
   Trainer's launches, granule 0 beside two lone Trainers of its seed,
   combined rays/s); ``run_extraction`` over the mesh on the voxelgrid,
   equal to the unsharded query bit for bit. The collectives of more than
   one rank run in the CPU tests (gloo).
10. Tools: the measurement entry points as a user runs them.
   ``tools.bench_dma_gather`` at both table sizes, a table of 2^21 entries
   (16 MiB, inside the L2) and the 21,141,696-entry table of
   ``instant_ngp_occ21.json`` (169 MB, beyond it): among its curves kernel
   T2 (the block fetch, ``csrc/block_fetch.cu``) at 1, 4 and 32 rows a run,
   2^17 rows of 512 bytes a call, held to its plain version
   (``torch.equal``) and timed beside it, ``index_select`` of the same rows
   and its bound; these give T2's row of the kernels line. Then the port's bench
   (``atmonr_tpu_torch.bench.main``: its JSON lines, beside phase 6's
   ``[steady]`` rays/s), ``tools.profile_step`` on the flagship,
   ``tools.diag_fwd_breakdown``, ``tools.bench_trainer`` over two timed
   epochs and ``tools.bench_scaling`` at ``data=1`` (NCCL, one rank). Each
   prints its own lines; ``[tools]`` lines sum them up.
11. Quality and real scale: ``tools.real_scale_demo`` at its defaults from
   memory (``source=memory``: the card's machine has no h5py), the
   flagship unchanged on the 457 x 457-pixel, 90-view real-schema granule
   with every one of its rays on the card (``[real scale]`` lines: the ray
   count beside the JAX harness's 14,587,440, the ray store's MB, the build
   seconds, 59 warm and 200 timed steps beside phase 6's ``[steady]``, peak
   device memory, a 20 km / 2 km voxelgrid query); one
   ``quality_real_scale`` cell of the flagship on that dataset
   (``ab_importance.run``, 10 s, seed 0) scored over every ray (3,562
   slices of 4,096) beside the same cell's initial parameters; then
   ``tools.quality_matrix`` on ``occ13_32p24f`` and ``uniform128``, both
   synthetic scenes, seed 0, 5 s a cell, each beside its untrained PSNR
   (``[quality]`` lines). Every loss finite, every trained PSNR above its
   untrained one, and each part's K1/K2 launches what its steps,
   refreshes, extraction batches and eval slices imply (a count that
   differs raises). K1 and K2 are then held to their plain versions at the
   real-scale path's own points.
12. Collapse: ``tools.repro_occ15_collapse`` on
   ``instant_ngp_tpu_occ13_q8sr.json`` (the flagship without its guard),
   the smooth 96x48-pixel scene, 8,192 rays, 200 steps a cell: the JAX
   package's inits of seeds 0 and 4 (``convert.jax_ngp_init``, bit-equal to
   ``init_params(PRNGKey(1000 * s))``; on the TPU seed 4 collapsed and seed
   0 did not) and the port's inits of seeds 0 and 4, at bf16 MLP products.
   Each cell prints its trace, its branch gradient norms over steps 1-20
   and its outcome by the restart guard's rule; a non-finite loss raises, a
   collapse does not. Launches: what 200 steps, 13 refreshes and the eval
   imply.
13. Entry: ``graft_entry.entry()`` on the card (K1 bf16 for both grids,
   once each), its loss and colors against ``entry(device="cpu")``'s; then
   ``graft_entry.dryrun_multichip`` over NCCL on every card present (one
   rank here): the three ``dryrun_multichip OK`` lines, the ranks' K1 and K2
   launches summed (each must be launched).

Each main path (phases 4-5, phase 6's training and each of its three
grids, each configuration of phase 7, each path of phase 8 and of phase 9,
phase 10's tools, phase 11's quality path and phases 12 and 13) has every
launch count set to 0 just before it and read just after it. The
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
# K1p, the q8/f8/bf16 table preparation of the same TPU kernel (its pack_tables)
K1P_SOURCE = "atmonr_tpu_torch/csrc/quantize.cu"
K1P_NO_LIBRARY = "no single PyTorch call computes a per-level quantization"
# the bf16 instance's plain version is one library call, the cast, which it
# replaces to carry a kernel name of the port's own in a device trace
K1P_BF16_LIBRARY = "table.to(torch.bfloat16)"
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
# The extract phase: the grids at the extract CLI's defaults (l1c at a 25 m
# ladder, 801 levels), queried in the CLI's 32,768-point batches. Card
# against CPU on 16,384 points of each grid fixed by seed 0, float32 MLPs
# and the card's preprocessor on both (as for the trained model above):
# rows outside rtol 1e-4 + 1e-6 of max|sigma| at most 1%. Orbit frames at
# the renderer's defaults; one frame held to the CPU's to 1e-4.
EXTRACT_BATCH = 32768
EXTRACT_COMPARE = 16384
SIGMA_RTOL, SIGMA_ATOL, SIGMA_BAD = 1e-4, 1e-6, 0.01
ORBIT_FRAMES, ORBIT_CHECK_FRAME, FRAME_TOL = 60, 7, 1e-4
ORBIT_RES = (640, 480, 192)  # width, height, samples a ray
# the frame held to the CPU's: the same camera at a quarter of the width and
# height (at full size the CPU takes ~8 s for it)
ORBIT_CHECK_RES = (160, 120, 192)
# configs/nerf.json's path: train steps (past three epoch ends at 4,096 rays),
# rays rendered on the card and on the CPU; the include_height paths' steps
NERF_STEPS, NERF_COMPARE, HEIGHT_STEPS = 48, 512, 8
# the multi-device phase: sharded steps held to the unsharded Trainer's,
# blocks of steady steps of each, steps of each granule. K2's float atomics
# add in another order on every step and AdamW's eps of 1e-15 turns a small
# gradient's sign into a full step, so two runs of the same steps drift
# apart, more with every step: the hash tables' relative L2 distance is held
# to MULTI_TABLE_REL_L2 after MULTI_STEPS (3.9e-3 measured, NVIDIA H100 80GB
# HBM3, 700 W), and a granule's after GRANULE_STEPS to GRANULE_SPREADS times
# that between two lone Trainers of the same seed (0.124 measured for a
# granule against one lone Trainer)
MULTI_STEPS, MULTI_BLOCKS, GRANULE_STEPS = 4, 4, 32
MULTI_TABLE_REL_L2, GRANULE_SPREADS = 0.02, 3.0
# the tools phase: T2 (the block fetch) against its plain version on two
# tables of 512-byte rows, 2^21 entries of two f32 features (16 MiB, inside
# the 50 MB L2) and the 21,141,696 of configs/instant_ngp_occ21.json
# (169 MB, beyond it), at the JAX tool's 2^17 rows a call
T2_SOURCE = "atmonr_tpu_torch/csrc/block_fetch.cu"
T2_REPLACES = "tools/bench_dma_gather.py:36"
T2_TABLES = (("2^21 entries", 32_768), ("21,141,696 entries", 330_339))
T2_RPDS = (1, 4, 32)
SCALING_WARM_ITERS = 100  # bench_scaling's warm-up cap here (its own: 1,200)
# the quality phase: the real-scale demo on the 457 x 457 x 90-view
# real-schema granule from memory (the card's machine has no h5py) at its
# defaults, one quality cell of the flagship on its dataset for
# REAL_CELL_BUDGET seconds (its eval over every ray), and the quality
# matrix's QM_VARIANTS on both scenes for QM_BUDGET seconds a cell, seed 0
REAL_DEMO_ARGS = ["source=memory"]
JAX_REAL_RAYS = 14_587_440  # the JAX real-scale harness's num_rays (docs/quality_real_scale.jsonl)
REAL_CELL_BUDGET = 10.0
COLLAPSE_CONFIG = "configs/instant_ngp_tpu_occ13_q8sr.json"
COLLAPSE_CELLS = (("jax", 0), ("jax", 4), ("port", 0), ("port", 4))
COLLAPSE_STEPS = 200
QM_VARIANTS, QM_SCENES, QM_BUDGET = "occ13_32p24f,uniform128", "smooth,hard", 5.0


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


def k1p_bound(cfg, noise: bool) -> tuple[float, str]:
    """Least time for K1p on grid ``cfg``: the table read once (8 bytes a
    row), and the noise where there is noise, the codes (2 bytes a row) and
    the scales written once, over the memory rate; against its float32
    operations (an entry's max, division, rounding or add and floor, and
    clamp: 5) over the float32 peak."""
    rows = cfg.total_params
    n_bytes = rows * (8 + (8 if noise else 0) + 2) + cfg.n_levels * 4
    ops = rows * 2 * 5
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1p_bf16_bound(cfg) -> tuple[float, str]:
    """Least time for K1p's bf16 instance on grid ``cfg``: the table read
    once (8 bytes a row) and the bf16 table written once (4 bytes a row)
    over the memory rate; one rounding an entry."""
    rows = cfg.total_params
    t_bytes, t_ops = rows * 12 / PEAK_BYTES_S, rows * 2 / PEAK_F32_S
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
    from atmonr_tpu_torch import run_extraction
    from atmonr_tpu_torch.ops.block_fetch import block_fetch
    from atmonr_tpu_torch.ops.hash_bwd import hash_bwd
    from atmonr_tpu_torch.ops.hash_gather import hash_gather

    from atmonr_tpu_torch.ops.hash_gather import quantize_tables, round_table_bf16

    for counts in (hash_gather.launches, quantize_tables.launches, round_table_bf16.launches,
                   hash_bwd.launches, block_fetch.launches):
        for key in counts:
            counts[key] = 0
    run_extraction.graph_batches = run_extraction.eager_batches = run_extraction.captures = 0
    run_extraction.staged_batches = 0


def graph_counts() -> tuple[int, int, int]:
    """``run_extraction``'s (graph_batches, eager_batches, captures)."""
    from atmonr_tpu_torch import run_extraction

    return run_extraction.graph_batches, run_extraction.eager_batches, run_extraction.captures


def check_graphed(tag: str, n: int, counts: tuple[int, int, int]) -> None:
    """The graph counters of one ``run_extraction`` of n points on the card
    in ``EXTRACT_BATCH`` batches: with two full batches or more, one capture
    on the first (its warm-up runs eagerly) and a replay for each later
    one; the tail and a lone full batch run eagerly. Every batch went
    through the pinned ring (``run_extraction.staged_batches``)."""
    from atmonr_tpu_torch import run_extraction

    full, batches = n // EXTRACT_BATCH, -(-n // EXTRACT_BATCH)
    want = (full - 1, batches - full + 1, 1) if full > 1 else (0, batches, 0)
    if counts != want:
        raise RuntimeError(f"{tag}: graph_batches, eager_batches, captures {counts}, "
                           f"expected {want}")
    if run_extraction.staged_batches != batches:
        raise RuntimeError(f"{tag}: staged_batches {run_extraction.staged_batches}, "
                           f"expected the call's {batches} batches")


def read_counts() -> dict:
    """Every launch count, keyed as the kernel rows are: ("K1", mode, D),
    ("K1p", mode, D), ("K2", None, D) and ("T2", None, rows a descriptor)."""
    from atmonr_tpu_torch.ops.block_fetch import block_fetch
    from atmonr_tpu_torch.ops.hash_bwd import hash_bwd
    from atmonr_tpu_torch.ops.hash_gather import hash_gather, quantize_tables, round_table_bf16

    counts = {("K1", mode, d): n for (mode, d), n in hash_gather.launches.items()}
    counts.update({("K1p", mode, d): n for (mode, d), n in quantize_tables.launches.items()})
    counts.update({("K1p", "bf16", d): n for d, n in round_table_bf16.launches.items()})
    counts.update({("K2", None, d): n for d, n in hash_bwd.launches.items()})
    counts.update({("T2", None, rpd): n for rpd, n in block_fetch.launches.items()})
    return counts


def launched(counts: dict) -> dict:
    """The counts that are not 0."""
    return {k: n for k, n in counts.items() if n}


def show(counts: dict) -> str:
    return ", ".join(
        f"{k[0]}{' ' + k[1] if k[1] else ''} {'rpd' if k[0] == 'T2' else 'D'}={k[2]} x{n}"
        for k, n in sorted(
            launched(counts).items(), key=lambda kv: (kv[0][0], str(kv[0][1]), -kv[0][2]))
    ) or "none"


def encodes(mode: str, d3: int, d2: int = 0) -> dict:
    """The launches of ``d3`` and ``d2`` hash encodes in ``mode`` at D=3 and
    D=2: K1 once each and, in q8, f8 and bf16, K1p (the table's
    preparation) once each too."""
    want = {("K1", mode, 3): d3, ("K1", mode, 2): d2}
    if mode in ("q8", "f8", "bf16"):
        want.update({("K1p", mode, 3): d3, ("K1p", mode, 2): d2})
    return launched(want)


def step_counts(mode: str, steps: int, k1_d3_extra: int = 0, k1_d2_extra: int = 0,
                k1_d3_per_step: int = 1) -> dict:
    """The launches of ``steps`` train steps in ``mode``: an encode (K1, and
    K1p in q8/f8) and K2 once per grid per step (D=3 encodes
    ``k1_d3_per_step`` times), plus the encodes outside the backward
    (refreshes, forwards, extraction batches)."""
    want = encodes(mode, k1_d3_per_step * steps + k1_d3_extra, steps + k1_d2_extra)
    want.update({("K2", None, 3): steps, ("K2", None, 2): steps})
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
    """The CUDA kernels (one nvcc each) and the host library (g++), all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    from atmonr_tpu_torch import _build, native

    def build_host():
        t0 = time.perf_counter()
        path, report = _build.build_host("atmonr_native")
        return path, report, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(build_host)
        built = _build.build_all(("hash_gather", "quantize", "hash_bwd", "block_fetch"),
                                 verbose=True)
        host_path, host_report, host_s = host.result()
    log(f"[build] {len(built)} CUDA libraries, one nvcc each, and the host library, all "
        f"together in {time.perf_counter() - t0:.2f} s")
    for path, report in built.values():
        log(f"[build] {path.name}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {host_path.name}: g++ {' '.join(_build.GXX_FLAGS)} in {host_s:.2f} s"
        f"{' (warnings: ' + host_report.strip() + ')' if host_report.strip() else ''}; "
        f"OpenMP threads {native.num_threads()} of {torch.get_num_threads()} torch host threads")


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


def check_k1p(mode: str, label: str, cfg, table, noise=None, reps: int = 50) -> dict:
    """K1p in ``mode`` (q8 with stochastic-rounding ``noise`` where given)
    against its plain version on the same card tensors: raises unless the
    codes and the scales are equal bit for bit and the launch counter moved
    by one; returns the times (device ms by graph replay, of the kernel and
    of the plain version; per call with the host launch, of both) and the
    bound."""
    from atmonr_tpu_torch.ops import hash_gather as hgo
    from atmonr_tpu_torch.ops.kernel_plan import quantize_plan
    from atmonr_tpu_torch.utils.timing import graph_ms, median_ms

    key = (mode, cfg.n_dims)
    before = hgo.quantize_tables.launches[key]
    codes, scales = hgo.quantize_tables(table, cfg, mode, noise)
    torch.cuda.synchronize()
    if hgo.quantize_tables.launches[key] != before + 1:
        raise RuntimeError("K1p launch counter did not move")

    def plain():
        if mode == "q8":
            return hgo.quantize_tables_q8(table, cfg, noise)
        return hgo.quantize_tables_f8(table, cfg)

    want_codes, want_scales = plain()
    wrong = int((codes.view(torch.uint8) != want_codes.view(torch.uint8)).sum())
    if wrong or not torch.equal(scales, want_scales):
        raise RuntimeError(f"K1p {mode} {label} differs from its plain version: {wrong} codes, "
                           f"scales equal {torch.equal(scales, want_scales)}")
    kernel = lambda: hgo.quantize_tables(table, cfg, mode, noise)  # noqa: E731
    call_ms = median_ms(kernel, reps=reps, warmup=10)
    ms = graph_ms(kernel)
    plain_ms = median_ms(plain, reps=10)
    plain_device_ms = graph_ms(plain)
    plan = quantize_plan(cfg)
    # an empty kernel in K1p's grid and cluster shape: the launch's own cost
    floor_ms = graph_ms(lambda: hgo.quantize_launch_floor(plan, table.device))
    bound_ms, bound_by = k1p_bound(cfg, noise is not None)
    log(f"[kernel] K1p {mode}{' noise' if noise is not None else ''} {label} D={cfg.n_dims} "
        f"T={cfg.total_params}: codes and scales equal the plain version's bit for bit, device "
        f"{ms:.4f} ms, launch floor {floor_ms:.4f} ms, per call with launch {call_ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms a call (device {plain_device_ms:.4f} ms by graph replay), "
        f"bound {bound_ms:.4f} ms ({bound_by}), library ms null: {K1P_NO_LIBRARY}; "
        + plan.describe())
    return {"max_abs_err": 0.0, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "plain_device_ms": plain_device_ms, "launch_floor_ms": floor_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_k1p_bf16(label: str, cfg, table, reps: int = 50) -> dict:
    """K1p's bf16 instance against ``table.to(torch.bfloat16)`` on the same
    card tensor: raises unless equal bit for bit and the launch counter
    moved by one; returns the times (device ms by graph replay, of the
    kernel and of the cast; per call with the host launch) and the bound."""
    from atmonr_tpu_torch.ops import hash_gather as hgo
    from atmonr_tpu_torch.utils.timing import graph_ms, median_ms

    before = hgo.round_table_bf16.launches[cfg.n_dims]
    got = hgo.round_table_bf16(table, cfg)
    torch.cuda.synchronize()
    if hgo.round_table_bf16.launches[cfg.n_dims] != before + 1:
        raise RuntimeError("K1p bf16 launch counter did not move")
    want = table.to(torch.bfloat16)
    wrong = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    if wrong or got.shape != want.shape:
        raise RuntimeError(f"K1p bf16 {label} differs from the cast: {wrong} entries")
    kernel = lambda: hgo.round_table_bf16(table, cfg)  # noqa: E731
    call_ms = median_ms(kernel, reps=reps, warmup=10)
    ms = graph_ms(kernel)
    plain_ms = graph_ms(lambda: table.to(torch.bfloat16))
    bound_ms, bound_by = k1p_bf16_bound(cfg)
    log(f"[kernel] K1p bf16 {label} D={cfg.n_dims} T={cfg.total_params}: equal to "
        f"{K1P_BF16_LIBRARY} bit for bit, device {ms:.4f} ms, per call with launch "
        f"{call_ms:.4f} ms, the cast {plain_ms:.4f} ms (graph replay), bound {bound_ms:.4f} ms "
        f"({bound_by}; {cfg.total_params * 12 / 1e6:.1f} MB)")
    return {"max_abs_err": 0.0, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def k1p_rows(label: str, cfg, table, noise) -> list[dict]:
    """K1p's rows of the kernels line at grid ``cfg``: q8 (the row's times
    those of the rounding the flagship takes there: stochastic on the
    position grid, to nearest on the surface grid; the other beside them)
    and f8."""
    rows = []
    rounding = {False: check_k1p("q8", label, cfg, table),
                True: check_k1p("q8", label, cfg, table, noise)}
    noisy = cfg.n_dims == 3
    for mode, res in (("q8", rounding[noisy]), ("f8", check_k1p("f8", label, cfg, table))):
        noise_note = ", noise" if mode == "q8" and noisy else ""
        row = {
            "name": f"quantize {mode} D={cfg.n_dims} ({label} grid{noise_note})",
            "route": "cuda", "source": K1P_SOURCE, "replaces": K1_REPLACES,
            "key": ("K1p", mode, cfg.n_dims), "launches": 0, "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"], "plain_device_ms": res["plain_device_ms"],
            "launch_floor_ms": res["launch_floor_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
        }
        if mode == "q8":
            other = rounding[not noisy]
            row.update({f"ms_{'round' if noisy else 'noise'}": other["ms"],
                        f"bound_ms_{'round' if noisy else 'noise'}": other["bound_ms"]})
        rows.append(row)
    res = check_k1p_bf16(label, cfg, table)
    rows.append({
        "name": f"round bf16 D={cfg.n_dims} ({label} grid)", "route": "cuda",
        "source": K1P_SOURCE, "replaces": K1_REPLACES, "key": ("K1p", "bf16", cfg.n_dims),
        "launches": 0, "max_abs_err": res["max_abs_err"], "ms": res["ms"],
        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
        "library_ms": res["plain_ms"],
    })
    return rows


def phase_kernels(encodings: dict, big_encoding: dict) -> list[dict]:
    """K1 (four table types), K1p (q8 and f8) and K2 against their plain
    versions at the flagship shapes, on uniform random points; K1p also at a
    2^14 position grid; K1 bf16 D=3 also over the 2^21-entry table of
    ``big_encoding``."""
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
        rows += k1p_rows(label, cfg, table, noise)
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

    # K1p at a 2^14 position grid, beside the flagship's 2^13
    cfg = hg.HashGridConfig.from_options(dict(encodings["pos"], log2_hashmap_size=14), 3)
    table = torch.rand((cfg.total_params, 2), generator=gen, device=dev) * 2e-4 - 1e-4
    noise = torch.rand(table.shape, generator=gen, device=dev)
    for row in k1p_rows("pos 2^14", cfg, table, noise):
        main = next(r for r in rows if r["key"] == row["key"])
        main.update({f"{k}_2p14_table": row[k] for k in ("ms", "plain_ms", "bound_ms")})
    del table, noise

    # bf16 over a table that leaves the L2 cache: every gather is a sector
    # from device memory
    cfg = hg.HashGridConfig.from_options(big_encoding, 3)
    m = 196_608
    table = torch.rand((cfg.total_params, 2), generator=gen, device=dev) * 2e-4 - 1e-4
    x = torch.rand((m, 3), generator=gen, device=dev)
    big = check_k1("bf16", "pos 2^21", cfg, table, x, reps=20)
    prep = check_k1p_bf16("pos 2^21", cfg, table, reps=20)
    row = next(r for r in rows if r["key"] == ("K1p", "bf16", 3))
    row.update(ms_2p21_table=prep["ms"], plain_ms_2p21_table=prep["plain_ms"],
               bound_ms_2p21_table=prep["bound_ms"])
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sigma = run_extraction(pipe, xyz, batch_size=32768)
    extract_s = time.perf_counter() - t0
    counts = read_counts()
    # ---- end of the main path ----
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    n_batches = -(-N_EXTRACT // 32768)
    if sigma.shape != (N_EXTRACT, 1) or not np.all(np.isfinite(sigma)) or np.any(sigma < 0):
        raise RuntimeError("extraction result not finite, non-negative, (N, 1)")
    if launched(counts) != encodes("q8", 1 + 5 + n_batches, 5):
        raise RuntimeError(f"launches on the inference path: {show(counts)}")
    check_graphed("extract", N_EXTRACT, graph_counts())
    steady = statistics.median(fwd_s[1:4])
    log(f"[slice] occupancy refresh ({pipe.occ_cfg.num_cells} cells): {refresh_s * 1e3:.2f} ms, "
        f"{pipe.occ_cfg.num_cells / refresh_s:.0f} cells/s on {card}")
    log(f"[slice] forward of {BATCH} rays (key=None, median of batches 2-4): "
        f"{steady * 1e3:.2f} ms = {BATCH / steady:.0f} rays/s on {card}; all five: "
        + ", ".join(f"{s * 1e3:.2f}" for s in fwd_s) + " ms")
    graph_batches, eager_batches, _ = graph_counts()
    log(f"[extract] {N_EXTRACT} points in {n_batches} batches: {extract_s:.3f} s = "
        f"{N_EXTRACT / extract_s:.0f} points/s on {card}; sigma max {float(sigma.max()):.3g} m^-1; "
        f"graph_batches {graph_batches}, eager_batches {eager_batches}, staged_batches "
        f"{run_extraction.staged_batches}; device peak {peak_mb:.3f} MB over the call "
        f"({resident / 1e6:.3f} MB resident before it; sigma {sigma.nbytes / 1e6:.3f} MB, the "
        f"points as float32 would be {N_EXTRACT * 12 / 1e6:.3f} MB)")
    log(f"[slice] launches on the inference path: {show(counts)}; K2 none")
    return counts, {"config": config, "ds": ds, "pipe": pipe, "batch": batches[0]}


def log_profile(prof, label: str, unprofiled_us: float, wall_us: float, card: str,
                top: int) -> tuple[float, dict, dict]:
    """Device time by kernel of one profiled call, and the card's idle
    share over the unprofiled call and over the profiled one. Returns the
    busy microseconds, and the microseconds and the launches by kernel
    name."""
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
    return (busy_us, {name: sum(ts) for name, ts in by_name.items()},
            {name: len(ts) for name, ts in by_name.items()})


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


def _bad_rays(card: dict, cpu: dict, keys, n: int) -> tuple[torch.Tensor, dict]:
    """Rays where any of ``keys`` differs between the card's outputs and the
    CPU's by more than rtol 1e-4 plus 1e-6 of the CPU output's largest
    value, and each output's max abs error against its largest value."""
    bad = torch.zeros(n, dtype=torch.bool)
    worst = {}
    for k in keys:
        a, b = card[k].cpu(), cpu[k]
        worst[k] = f"{float((a - b).abs().max()):.3g} of {float(b.abs().max()):.3g}"
        err = (a - b).abs() > 1e-4 * b.abs() + 1e-6 * b.abs().max()
        bad |= err.reshape(n, -1).any(dim=1)
    return bad, worst


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
    _, worst = _bad_rays(out_card, out_cpu, out_cpu, BATCH)
    bad, _ = _bad_rays(out_card, out_cpu, ("color_map_fine", "color_surf", "z_vals_fine"), BATCH)
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
    check_epoch_image(trainer)
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
    ctx["steady_rays_s"] = BATCH / med
    before = read_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(idx[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    after = read_counts()
    if {k: after[k] - before[k] for k in after if after[k] != before[k]} != step_counts("q8", 1):
        raise RuntimeError(f"the profiled step's launches: {show(before)} -> {show(after)}")
    busy_us, by_name, n_by_name = log_profile(prof, "train step (no refresh)", med * 1e6,
                                              wall_us, card, top=10)
    # the table preparation on the step: K1p's one clustered kernel, one
    # launch a table (its instances differ by mode and noise alone), and any
    # kernel left that scatters (the plain quantizer's per-level maximum was
    # a scatter_reduce, the step's largest device op)
    k1p = {n: t for n, t in by_name.items() if "quantize_" in n}
    k1p_kernels = {"quantize_kernel" if "quantize_kernel" in n else n for n in k1p}
    if k1p_kernels != {"quantize_kernel"} or sum(n_by_name[n] for n in k1p) != 2:
        raise RuntimeError(f"the profiled step's K1p kernels: {sorted(k1p)} x "
                           f"{[n_by_name[n] for n in sorted(k1p)]}, expected quantize_kernel "
                           "launched twice (one launch for each of the two tables)")
    scatter = {n: t for n, t in by_name.items() if "scatter" in n.lower()}
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"[profile] train step: {sum(n_by_name.values())} kernel launches, busy {busy_us:.0f} us; "
        "largest device ops: "
        + "; ".join(f"{t:.1f} us x{n_by_name[n]} {n[:60]}" for n, t in largest)
        + f"; K1p {sum(k1p.values()):.1f} us in {sum(n_by_name[n] for n in k1p)} launches; "
        "kernels that scatter: " + ("; ".join(f"{t:.1f} us x{n_by_name[n]} {n[:160]}"
                                              for n, t in scatter.items()) or "none"))

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
    ctx.update(trainer=trainer, train_config=dict(config, trainer=tcfg))
    return counts


def check_epoch_image(trainer) -> None:
    """The epoch's RGB comparison after training, surface | atmosphere |
    full | target: the JAX Trainer's layout, equal to the image assembled
    here on the host from the same three progress buffers."""
    ds = trainer.dataset
    pix = trainer.progress_pixels.cpu().numpy()
    img = trainer.epoch_image()
    h, w = ds.img_shp
    nv = ds.view_idx.shape[0]

    def rgb(values: np.ndarray) -> np.ndarray:
        flat = np.zeros(h * w * nv, np.float32)
        flat[ds.ray_filter] = values
        return np.clip(flat.reshape(h, w, nv)[:, :, ds.best_rgb_idx] / ds.max_i, 0, 1)

    want = np.concatenate([rgb(pix[:, 1]), rgb(pix[:, 2]), rgb(pix[:, 0]), rgb(ds.ray_rad)],
                          axis=1)
    written = [int(np.count_nonzero(pix[:, i])) for i in range(3)]
    log(f"[train] epoch image (surface | atmosphere | full | target) {img.shape} {img.dtype} "
        f"of views {ds.best_rgb_idx}, in [{float(img.min()):.3g}, {float(img.max()):.3g}]; "
        f"non-zero progress pixels (full, surface, atmosphere) {written} of {len(pix)}")
    if img.shape != (h, 4 * w, 3) or not np.array_equal(img, want):
        raise RuntimeError("the epoch image is not the host's surface | atmosphere | full | "
                           "target of the progress buffers")
    if min(written) == 0:
        raise RuntimeError("a progress buffer was never written")


def save_experiment(ctx: dict, root: str) -> Path:
    """The trained flagship as ``python -m atmonr_tpu_torch.scripts.train``
    leaves an experiment: ``args.json`` and ``config.json`` (written by its
    ``setup_dir``) and the trainer's checkpoint, under
    ``<root>/output/chip_smoke``."""
    from atmonr_tpu_torch.scripts import train as train_cli

    args = train_cli.parse_args([
        "--exp-name", "chip_smoke", "--config-path", str(CONFIG), "--scene-filename", SCENE,
        "--data-root", root, "--num-iters", str(TRAIN_STEPS)])
    out = train_cli.setup_dir(args, ctx["train_config"])
    ctx["trainer"].save(out, ctx["trainer"].epoch_idx)
    ctx["trainer"].checkpointer.wait()
    return out


def compare_sigma(tag: str, xyz: np.ndarray, sigma: np.ndarray, pipe, cpu) -> None:
    """``EXTRACT_COMPARE`` points of a grid (seed 0) queried on the card and
    on the CPU with float32 MLPs and the card's preprocessor on both; raises
    if more than ``SIGMA_BAD`` of them differ by more than ``SIGMA_RTOL`` plus
    ``SIGMA_ATOL`` of max|sigma|. Also prints, without a limit, the same
    share with each device's own float32 preprocessor, and for the main
    run's own sigma (bfloat16 MLP products) against the CPU's."""
    from atmonr_tpu_torch import run_extraction

    idx = np.sort(np.random.default_rng(0).choice(xyz.shape[0], EXTRACT_COMPARE, replace=False))
    pts = xyz[idx]
    own_pre = cpu.point_preprocessor
    shared = lambda p: pipe.point_preprocessor(p.to(pipe.device)).cpu()  # noqa: E731
    results = {}
    try:
        for label, dtype, pre in (("bfloat16 MLPs (the main run), own preprocessors",
                                   torch.bfloat16, own_pre),
                                  ("float32 MLPs, own preprocessors", torch.float32, own_pre),
                                  ("float32 MLPs, one preprocessor", torch.float32, shared)):
            pipe.compute_dtype = cpu.compute_dtype = dtype
            cpu.point_preprocessor = pre
            card = sigma[idx] if dtype == torch.bfloat16 else run_extraction(
                pipe, pts, batch_size=EXTRACT_BATCH)
            host = run_extraction(cpu, pts, batch_size=EXTRACT_BATCH)
            bad = (np.abs(card - host) > SIGMA_RTOL * np.abs(host)
                   + SIGMA_ATOL * np.abs(host).max()).any(axis=1)
            results[label] = (bad.mean(), float(np.abs(card - host).max()),
                              float(np.abs(host).max()), bool(np.isfinite(card).all()))
    finally:
        pipe.compute_dtype = cpu.compute_dtype = torch.bfloat16
        cpu.point_preprocessor = own_pre
    log(f"[compare] {tag}: card vs CPU at {EXTRACT_COMPARE} points, rows outside rtol "
        f"{SIGMA_RTOL:g} + {SIGMA_ATOL:g} of max|sigma| (max abs err, max|sigma|): "
        + "; ".join(f"{k} {v[0]:.4%} ({v[1]:.3g}, {v[2]:.3g})" for k, v in results.items())
        + f"; the limit {SIGMA_BAD:.0%} is on the last")
    share, _, _, finite = results["float32 MLPs, one preprocessor"]
    if not (finite and share <= SIGMA_BAD):
        raise RuntimeError(f"{tag}: card and CPU sigma disagree on more than {SIGMA_BAD:.0%}")


def check_extract(tag: str, grid, sigma: np.ndarray, counts: dict, build_s: float,
                  query_s: float, peak_mib: float, card: str) -> None:
    """A grid's result: finite, non-negative, one value per point, and K1 q8
    D=3 and K1p q8 D=3 launched once per 32,768-point batch and nothing
    else."""
    n = len(grid)
    batches = -(-n // EXTRACT_BATCH)
    if sigma.shape != (n, 1) or not np.all(np.isfinite(sigma)) or np.any(sigma < 0):
        raise RuntimeError(f"{tag}: sigma not finite, non-negative, (N, 1)")
    if launched(counts) != encodes("q8", batches):
        raise RuntimeError(f"{tag}: launches {show(counts)}, expected K1 and K1p q8 D=3 "
                           f"x{batches}")
    check_graphed(tag, n, graph_counts())
    log(f"[{tag}] {n} points, shape {grid.shp}: grid built on the host in {build_s:.2f} s; "
        f"run_extraction (both copies included) {query_s:.3f} s = {n / query_s:.0f} points/s; "
        f"K1 launches {show(counts)} for ceil({n}/{EXTRACT_BATCH}) = {batches} batches; peak "
        f"device memory {peak_mib:.0f} MiB; sigma max {float(sigma.max()):.3g} m^-1; on {card}")


def compare_global_walks(grid, args, ds, build_s: float, card: str) -> None:
    """The global grid of the extract CLI (the host library's walk writing
    int64 keys) against the same grid built with the numpy walk: equal
    voxels and points in the same order, and the host seconds of both."""
    from atmonr_tpu_torch.extract import datasets as xd

    t0 = time.perf_counter()
    plain = xd.HARP2GlobalGridExtractDataset(
        ds, scale=args.scale, grid_res=args.grid_res, vstretch=args.vstretch,
        lon_crop=args.lon_crop, walk_keys=xd.walk_keys_numpy)
    plain_s = time.perf_counter() - t0
    same = np.array_equal(plain.voxels, grid.voxels) and np.array_equal(plain.xyz, grid.xyz)
    log(f"[extract globalgrid] host build of {len(grid)} points from {len(ds)} rays: "
        f"{build_s:.2f} s with the host library's walk writing int64 keys (the CLI's), "
        f"{plain_s:.2f} s with the numpy walk; the same voxels and points in the same order: "
        f"{same}; on the host of {card}")
    if not same:
        raise RuntimeError("the numpy walk and the host library give other global grids")


def phase_extract(ctx: dict, card: str, rows: list[dict]) -> dict:
    """The extraction entry points on the trained flagship, saved as the
    train CLI leaves an experiment and restored from it: the l1c grid at a
    25 m ladder and the voxelgrid at the CLI's defaults through
    ``get_extract_dataset`` and ``run_extraction``, the globalgrid through
    the whole extract CLI (``main``) at its defaults, each with its launch
    counts set to 0 just before and read just after; then 60 orbit frames of
    the l1c volume. Returns the counts by path."""
    import warnings

    from atmonr_tpu_torch import get_extract_dataset, get_pipeline, run_extraction
    from atmonr_tpu_torch.extract.orbit_render import orbit_camera, render_frame, render_orbit
    from atmonr_tpu_torch.ops import hash_gather as hgo
    from atmonr_tpu_torch.ops.kernel_plan import level_plan
    from atmonr_tpu_torch.scripts import extract as extract_cli
    from atmonr_tpu_torch.scripts.make_video import volume_for_render
    from atmonr_tpu_torch.training.checkpoint import restore_params

    log("[extract] not called on this machine, which has no h5py: the netCDF writers, the "
        "L1C, DEM and EarthCARE readers and make_video's read_extract_sigma "
        "(tests/test_torch_extract.py and tests/test_torch_journey.py hold them to the JAX "
        "package on the CPU)")
    ds, paths = ctx["ds"], {}
    with tempfile.TemporaryDirectory() as root:
        out = save_experiment(ctx, root)
        config = json.loads((out / "config.json").read_text())
        pipe = get_pipeline(config["pipeline"], ds)
        cpu = get_pipeline(config["pipeline"], ds, device="cpu")
        epoch = restore_params(out, pipe)
        restore_params(out, cpu)
        cfg = pipe.pos_cfg
        log(f"[extract] restored epoch {epoch} of {out}; K1 q8 D=3 at a full batch of "
            f"{EXTRACT_BATCH} points: "
            + level_plan(cfg, EXTRACT_BATCH, hgo.ROW_BYTES["q8"], False).describe())

        volume = None
        for mode, kw in (("l1c", {"alt_step": 25.0}),
                         ("voxelgrid", {"horizontal_step": 3000.0, "alt_step": 250.0})):
            tag = f"extract {mode}"
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                grid = get_extract_dataset(mode, ds, **kw)
            build_s = time.perf_counter() - t0
            for w in caught:
                log(f"[{tag}] warning: {w.message}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- the main path: counts reset just before, read just after ----
            reset_counts()
            t0 = time.perf_counter()
            sigma = run_extraction(pipe, grid, batch_size=EXTRACT_BATCH)
            query_s = time.perf_counter() - t0
            paths[tag] = read_counts()
            # ---- end of the main path ----
            check_extract(tag, grid, sigma, paths[tag], build_s, query_s,
                          torch.cuda.max_memory_allocated() / 2**20, card)
            compare_sigma(tag, grid.xyz, sigma, pipe, cpu)
            if mode == "voxelgrid":
                ctx.update(voxelgrid=grid, extract_pipe=pipe)
                # where the time of a query goes: one more run, profiled
                from torch.profiler import ProfilerActivity, profile

                reset_counts()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run_extraction(pipe, grid, batch_size=EXTRACT_BATCH)
                    wall_us = (time.perf_counter() - t0) * 1e6
                _, _, n_by_name = log_profile(prof, f"{tag} run_extraction", query_s * 1e6,
                                              wall_us, card, top=8)
                # the launch counters count graph replays from the capture's
                # record: hold them to the kernels the trace saw
                check_graphed(f"{tag} profiled", len(grid), graph_counts())
                seen = {k: sum(c for name, c in n_by_name.items() if kernel in name)
                        for k, kernel in ((("K1", "q8", 3), "hash_gather_"),
                                          (("K1p", "q8", 3), "quantize_kernel"))}
                if launched(read_counts()) != seen:
                    raise RuntimeError(f"{tag} profiled: launch counters {show(read_counts())}, "
                                       f"the trace's kernels {seen}")
            if mode == "l1c":
                tail = len(grid) % EXTRACT_BATCH
                log(f"[{tag}] the tail batch of {tail} points: "
                    + level_plan(cfg, tail, hgo.ROW_BYTES["q8"], False).describe())
                # K1 at the batches' own points: the first full batch
                with torch.no_grad():
                    pts = torch.from_numpy(((grid.xyz[:EXTRACT_BATCH] - ds.offset) / ds.scale)
                                           .astype(np.float32)).to(pipe.device)
                    x = pipe._encoder_inputs(pts[None])[0].contiguous()
                k1 = check_k1("q8", "extract l1c batch", cfg, pipe.pos_table.detach(), x, reps=20)
                row = next(r for r in rows if r["key"] == ("K1", "q8", 3))
                row.setdefault("at_path_shapes", []).append({
                    "path": tag, "grid": "pos", "m": EXTRACT_BATCH, "table_rows": cfg.total_params,
                    "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
                    "bound_ms": k1["bound_ms"]})
                # the volume as extract_to_netcdf lays it out and make_video
                # orients and scales it
                na = grid.sample_alt.shape[0]
                volume = volume_for_render(sigma.reshape(grid.shp[0], grid.shp[1], na, 1), 0)
                volume = volume * ds.scale / 1000
            del grid, sigma

        # globalgrid: the whole extract CLI at its defaults
        tag = "extract globalgrid"
        argv = ["--exp-name", "chip_smoke", "--coord-mode", "globalgrid",
                "--extract-filename", "globalgrid.vdb", "--data-root", root]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = extract_cli.main(argv)
        cli_s = time.perf_counter() - t0
        paths[tag] = read_counts()
        # ---- end of the main path ----
        for w in caught:
            log(f"[{tag}] warning: {w.message}")
        check_extract(tag, run.grid, run.sigma, paths[tag], run.build_s, run.query_s,
                      torch.cuda.max_memory_allocated() / 2**20, card)
        vox, sig = np.load(out / "globalgrid_voxels.npy"), np.load(out / "globalgrid_sigma.npy")
        if vox.shape != (len(run.grid), 3) or not np.array_equal(sig, run.sigma):
            raise RuntimeError(f"{tag}: the .npy pair does not hold the grid's voxels and sigma")
        log(f"[{tag}] python -m atmonr_tpu_torch.scripts.extract {' '.join(argv)}: wrote "
            f"{vox.shape[0]} voxels and their sigma as the .npy pair (no OpenVDB here); the "
            f"whole CLI (dataset, grid, restore, query, writing) {cli_s:.2f} s on {card}")
        compare_sigma(tag, run.grid.xyz, run.sigma, pipe, cpu)
        compare_global_walks(run.grid, extract_cli.parse_args(argv), ds, run.build_s, card)
        del run

    # the orbit video's frames, on the card, of the l1c volume
    w, h, n = ORBIT_RES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_s, frames = [], []
    t0 = time.perf_counter()
    for frame in render_orbit(volume, ORBIT_FRAMES, width=w, height=h, n_samples=n):
        now = time.perf_counter()
        frame_s.append(now - t0)
        t0 = now
        frames.append(frame)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if len(frames) != ORBIT_FRAMES or any(f.shape != (h, w) or f.dtype != np.uint8 for f in frames):
        raise RuntimeError("orbit frames: wrong count, shape or type")
    eye, center = orbit_camera(volume.shape, ORBIT_CHECK_FRAME, ORBIT_FRAMES)
    cw, ch, cn = ORBIT_CHECK_RES
    got = render_frame(torch.from_numpy(volume).cuda(), torch.from_numpy(eye).cuda(),
                       torch.from_numpy(center).cuda(), width=cw, height=ch, n_samples=cn).cpu()
    t0 = time.perf_counter()
    want = render_frame(torch.from_numpy(volume), torch.from_numpy(eye), torch.from_numpy(center),
                        width=cw, height=ch, n_samples=cn)
    cpu_s = time.perf_counter() - t0
    err = float((got - want).abs().max())
    if not float(want.max()) > 0:
        raise RuntimeError("the orbit frame is blank")
    log(f"[orbit] {ORBIT_FRAMES} frames of the l1c volume {volume.shape} at {w}x{h}, {n} samples "
        f"a ray: {1e3 * sum(frame_s) / len(frame_s):.2f} ms a frame (median "
        f"{1e3 * statistics.median(frame_s):.2f}, first {1e3 * frame_s[0]:.2f}; host clock, the "
        f"frame's copy to the host included), peak device memory {peak_mib:.0f} MiB; uint8 "
        f"levels up to {max(int(f.max()) for f in frames)}; frame "
        f"{ORBIT_CHECK_FRAME} at {cw}x{ch} card vs CPU: max |brightness difference| {err:.3g} (tolerance "
        f"{FRAME_TOL:g}; brightest {float(want.max()):.3g}; the CPU took {cpu_s:.1f} s); on {card}")
    if not err <= FRAME_TOL:
        raise RuntimeError(f"orbit frame card vs CPU: {err} > {FRAME_TOL}")
    return paths


def steady_step_s(trainer, n_blocks: int, block: int) -> list[float]:
    """Seconds per step of ``n_blocks`` blocks of ``block`` ``Trainer.step``
    calls on fresh batches of the trainer's rows, each block ending in a
    synchronize (no epoch end inside)."""
    from atmonr_tpu_torch.data import batching

    b = trainer.rank_batch
    perm = batching.epoch_permutation(trainer.generators["perm"], trainer.rank_rays, b)
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
    held to what the config's sampler and ``mode`` imply (no D=3 launch
    where the position grid takes no kernel: the pair-bucket and 4-D
    grids). Then steady step times and one profiled step. Returns the
    counts and the objects."""
    from atmonr_tpu_torch import Trainer, get_pipeline, run_extraction
    from atmonr_tpu_torch.models import hash_grid as hg
    from torch.profiler import ProfilerActivity, profile

    t_begin = time.perf_counter()
    pcfg = config["pipeline"]
    pipe = get_pipeline(pcfg, ds)
    pos_kernel = hg.resolve_fwd_mode(pipe.pos_cfg) in hg.KERNEL_MODES
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
    if not pos_kernel:
        want = {k: n for k, n in want.items() if k[2] != 3}
    if launched(counts) != want:
        raise RuntimeError(f"[{tag}] launches: {show(counts)}; expected {show(want)}")
    sampler = "occupancy" if occ else "importance" if imp else "uniform"
    log(f"[{tag}] {sampler} sampler, {n} samples per ray = {BATCH * n} points per step, "
        f"{n_micro} micro-batch(es), pos table {pipe.pos_cfg.total_params} rows "
        f"({hg.resolve_fwd_mode(pipe.pos_cfg)}, {pipe.pos_cfg.n_dims}-D); inference part "
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
    log(f"[time] {tag}: {time.perf_counter() - t_begin:.1f} s")
    return {"counts": counts, "config": config, "ds": ds, "pipe": pipe, "trainer": trainer,
            "batch": batches[0]}


def check_path_kernels(tag: str, pipe, batch: dict, rows: list[dict]) -> dict:
    """K1 (in the pipeline's mode) and K2 against their plain versions at
    the shapes this path gives them: the pos grid on one forward's own
    sample points over the trained table (with the importance sampler also
    its coarse pass's points, which K2 never sees; none where the position
    grid takes no kernel), the surface grid on the batch's own surface
    points. K1 within ``K1_TOL * max|out|``; K2 within
    1e-4 * max|dW| (the points cluster). Each result goes into its kernel's
    row; returns them by (grid, kernel)."""
    from atmonr_tpu_torch.models import hash_grid as hg
    from atmonr_tpu_torch.ops.samplers import sample_uniform_bins

    dev = pipe.device
    b = batch["origin"].shape[0]
    draws = pipe.make_draws(b, torch.Generator(device=dev).manual_seed(13))
    with torch.no_grad():
        x, _ = pipe.sample_points(batch, draws)
        sets = [("pos", pipe.pos_cfg, pipe.pos_table.detach(), x.contiguous(), True)]
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
        if mode not in hg.KERNEL_MODES:  # a pair-bucket or 4-D grid
            continue
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


def compare_ray_builders(config: dict, ds) -> None:
    """The dataset's set-up on ``ds``'s granule with the host library's ray
    builder (the default, which every phase uses) and with the numpy one:
    host seconds of each, and their rays within the origin solve's 25 m
    (each ray stops its solve on its own in the library) and 1e-5 in
    direction."""
    from atmonr_tpu_torch import native
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.geo import wgs84

    times = {}
    for name, builder in (("host library", None), ("numpy", wgs84.get_rays)):
        t0 = time.perf_counter()
        other = HARP2Dataset(config["dataset"], ds.granule, ray_builder=builder)
        times[name] = time.perf_counter() - t0
    if not np.array_equal(other.ray_filter, ds.ray_filter):
        raise RuntimeError("the two ray builders keep other rays")
    d_origin = float(np.abs(other.ray_origin - ds.ray_origin).max())
    d_dir = float(np.abs(other.ray_dir - ds.ray_dir).max())
    log(f"[D] set-up of {len(ds)} rays: {times['host library']:.2f} s with the host library's "
        f"ray builder ({native.num_threads()} OpenMP threads), {times['numpy']:.2f} s with the "
        f"numpy one; origins within {d_origin:.3g} m, directions within {d_dir:.3g}; every "
        "phase runs on the host library's rays")
    if not (d_origin <= 25.0 and d_dir <= 1e-5):
        raise RuntimeError("the host library's rays differ from the numpy builder's")


def _tensors(obj, path=()) -> dict:
    """Every tensor of a nested checkpoint state, by its path, on the host."""
    if isinstance(obj, torch.Tensor):
        return {path: obj.detach().cpu().clone()}
    items = obj.items() if isinstance(obj, dict) else (
        enumerate(obj) if isinstance(obj, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(_tensors(v, path + (k,)))
    return out


def time_checkpoints(tag: str, trainer, card: str) -> None:
    """A synchronous save (``save_checkpoint``) against two asynchronous
    ones (the Trainer's ``checkpointer``: the first allocates its pinned
    buffers, the second reuses them), each after a synchronize as at an
    epoch's end: how long each blocks the caller, the background write's
    wall seconds, and the step time while a write is in flight against
    after. Each asynchronous save is followed at once by steps that update
    the state in place; every checkpoint reloads equal to the state at its
    save."""
    from atmonr_tpu_torch.training import checkpoint as ckpt

    mgr = trainer.checkpointer
    with tempfile.TemporaryDirectory() as root:
        states, block_ms, write_s, during, after = {}, [], [], [], []
        states[1] = _tensors(trainer.checkpoint_state())
        n_bytes = sum(t.numel() * t.element_size() for t in states[1].values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(root, 1, trainer.checkpoint_state())
        sync_ms = 1e3 * (time.perf_counter() - t0)
        for epoch in (2, 3):
            states[epoch] = _tensors(trainer.checkpoint_state())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(root, epoch, trainer.checkpoint_state())
            block_ms.append(1e3 * (time.perf_counter() - t0))
            during.append(steady_step_s(trainer, 1, 8)[0])
            mgr.wait()
            write_s.append(mgr.last_write_s)
            after.append(steady_step_s(trainer, 1, 8)[0])
        for epoch, want in states.items():
            got = _tensors(ckpt.restore_checkpoint(root, epoch)[0])
            if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want):
                raise RuntimeError(f"[{tag}] checkpoint {epoch} is not the state at its save")
    log(f"[{tag}] checkpoint of {n_bytes / 1e6:.1f} MB (parameters, grid, AdamW moments): "
        f"synchronous save {sync_ms:.1f} ms; asynchronous save blocks {block_ms[0]:.1f} ms "
        f"(allocating its pinned buffers), then {block_ms[1]:.1f} ms, its background write "
        f"{write_s[0]:.2f} s, {write_s[1]:.2f} s; 8 steps while the write runs "
        f"{1e3 * during[0]:.2f}, {1e3 * during[1]:.2f} ms a step, after it "
        f"{1e3 * after[0]:.2f}, {1e3 * after[1]:.2f}; each checkpoint reloads equal to the "
        f"state at its save, bit for bit; on {card}")


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
                   must_fall=True, steady=(4, BLOCK))
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
    compare_ray_builders(config, big)
    d = run_config("D occ21", config, big, card, steps=32, refresh=True, n_forwards=1,
                   must_fall=True, steady=(2, BLOCK))
    time_checkpoints("D occ21", d["trainer"], card)
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
    del r
    torch.cuda.empty_cache()

    # D with the pair-bucket hash: the position grid's hashed levels take the
    # window hash and no kernel (the exact gather over the bf16 table); the
    # surface grid K1 bf16 and K2 D=2 once per step
    d = run_config("D occ21_pb", load_config(CONFIGS / "instant_ngp_occ21_pb.json"), big, card,
                   steps=32, refresh=True, n_forwards=1, must_fall=True, steady=(2, BLOCK))
    pos_cfg = d["pipe"].pos_cfg
    if hg.resolve_fwd_mode(pos_cfg) != "xla_bf16" or any(n for k, n in d["counts"].items()
                                                          if k[2] == 3):
        raise RuntimeError("path D occ21_pb launched a D=3 kernel")
    log(f"[D occ21_pb] pair-bucket levels: "
        f"{sum(hg._use_hashed_tiles(pos_cfg, lv) for lv in range(pos_cfg.n_levels))} of "
        f"{pos_cfg.n_levels} (the hashed 3-D levels); no D=3 launch")
    check_path_kernels("D occ21_pb", d["pipe"], d["batch"], rows)
    phase_card_vs_cpu(d, share_preprocessor=True)
    paths["D pb"] = d["counts"]
    del d
    torch.cuda.empty_cache()
    r = run_config("D instant_ngp_pb", load_config(CONFIGS / "instant_ngp_pb.json"), big, card,
                   steps=2, steady=(1, 1))
    if r["trainer"].micro_batch != BATCH // 8 or any(n for k, n in r["counts"].items()
                                                     if k[2] == 3):
        raise RuntimeError("path D instant_ngp_pb: not 8 micro-batches, or a D=3 launch")
    paths["D micro pb"] = r["counts"]
    del r, big
    torch.cuda.empty_cache()

    # f32 and f8: the flagship config with both grids' mode set in memory
    for mode in ("f32", "f8"):
        config = copy.deepcopy(flagship["config"])
        ngp = config["pipeline"]["instant_ngp"]
        ngp["encoding"]["fwd_mode"] = mode
        ngp["surface_encoding"]["nested"][0]["fwd_mode"] = mode
        r = run_config(f"flagship {mode}", config, ds, card, steps=4, mode=mode, n_forwards=1,
                       steady=(1, BLOCK))
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


def nerf_step_bound(pipe, batch_size: int) -> tuple[float, float]:
    """(float32 operations, ms) of one NeRF train step's GEMMs, the least
    time at the float32 peak: every sample point's AtmoNeRF products (N_c
    points a ray through the coarse MLP, N_c + N_f through the fine), two
    operations a multiply-add, three products a layer forward and
    backward."""
    macs = 0
    for model, n in ((pipe.coarse, pipe.n_coarse), (pipe.fine, pipe.n_coarse + pipe.n_fine)):
        per_point = sum(getattr(model, f"fc{i}").weight.numel() for i in range(1, 12))
        macs += batch_size * n * per_point
    ops = 2 * 3 * macs
    return ops, 1e3 * ops / PEAK_F32_S


def nerf_card_vs_cpu(tag: str, config: dict, ds, pipe, batch: dict) -> None:
    """``NERF_COMPARE`` rays rendered deterministically on the card and on the
    CPU, the CPU taking the card's preprocessed points (as the other paths
    are held), each check at most 1% of rays outside rtol 1e-4 plus 1e-6 of
    the largest value:

    - independently on both devices: the coarse color map and weights and
      every fine depth. The fine color map's share is printed, not held: the
      fine samples invert the CDF of the coarse weights, whose last bits the
      two devices' GEMMs round differently, so the fine depths differ by
      ~1e-5 of their value, and a sample that moves by that much moves its
      2^13 pi encoding by a visible angle;
    - the CPU's fine pass at the card's fine samples (``sample_pdf``'s
      result shared, as the preprocessor is): the fine color map and
      weights."""
    from atmonr_tpu_torch import get_pipeline
    from atmonr_tpu_torch.pipelines import nerf as nerf_module

    cpu = get_pipeline(config["pipeline"], ds, device="cpu")
    cpu.load_state_dict(pipe.state_dict())
    if pipe.point_preprocessor:
        cpu.point_preprocessor = lambda pts: pipe.point_preprocessor(pts.to(pipe.device)).cpu()
    sub = {k: v[:NERF_COMPARE] for k, v in batch.items()}
    sub_cpu = {k: v.cpu() for k, v in sub.items()}
    sample_pdf, card_samples = nerf_module.sample_pdf, []

    def record(*args, **kwargs):
        card_samples.append(sample_pdf(*args, **kwargs))
        return card_samples[-1]

    try:
        with torch.no_grad():
            nerf_module.sample_pdf = record
            out_card = pipe(sub)
            nerf_module.sample_pdf = sample_pdf
            out_cpu = cpu(sub_cpu)
            nerf_module.sample_pdf = lambda *args, **kwargs: tuple(t.cpu() for t in card_samples[0])
            out_shared = cpu(sub_cpu)
    finally:
        nerf_module.sample_pdf = sample_pdf
    n = NERF_COMPARE
    own, worst_own = _bad_rays(out_card, out_cpu, ("color_map_coarse", "weights_coarse",
                                                   "z_vals_fine"), n)
    fine_own, worst_fine = _bad_rays(out_card, out_cpu, ("color_map_fine",), n)
    shared, worst_shared = _bad_rays(out_card, out_shared, ("color_map_fine", "weights_fine"), n)
    same = (out_card["z_vals_fine"].cpu() == out_cpu["z_vals_fine"]).all(dim=1)
    log(f"[compare] {tag} card vs CPU, {n} rays, deterministic, one preprocessor: independent "
        f"renders {int(own.sum())} rays ({float(own.float().mean()):.4%}) outside rtol 1e-4 + "
        f"1e-6 of max in the coarse color or weights or the fine depths ({worst_own}); the fine "
        f"color {int(fine_own.sum())} rays ({float(fine_own.float().mean()):.4%}, "
        f"{worst_fine}; {int(same.sum())} rays place every fine sample bit for bit alike; not "
        f"held); at the card's fine samples {int(shared.sum())} rays "
        f"({float(shared.float().mean()):.4%}) in the fine color or weights ({worst_shared})")
    if float(own.float().mean()) > 0.01 or float(shared.float().mean()) > 0.01:
        raise RuntimeError(f"{tag}: card and CPU renders disagree on more than 1% of the rays")


def run_nerf(tag: str, config: dict, ds, card: str, *, steps: int, full: bool) -> dict:
    """A NeRF configuration's main path at full width, random weights from
    seed 0, every launch count set to 0 just before and read just after
    (nothing may launch: the path's device work is GEMMs and plain
    PyTorch). With ``full``: deterministic forwards, a card-vs-CPU render,
    ``steps`` steps of ``Trainer.iterate`` (finite losses; the deterministic
    loss of the forwards' batches falls), steady
    ms per step beside the GEMM bound, one profiled step with its GEMM
    share, peak memory, and a voxel-grid extraction. Otherwise the steps
    alone, finite. Returns the counts."""
    from atmonr_tpu_torch import Trainer, get_extract_dataset, get_pipeline, run_extraction
    from torch.profiler import ProfilerActivity, profile

    pipe = get_pipeline(config["pipeline"], ds, generator=torch.Generator().manual_seed(0))
    tcfg = dict(config["trainer"], num_iters=steps)
    b = int(tcfg["batch_size"])
    rays = ds.rays()
    batches = [{k: v[i * b:(i + 1) * b] for k, v in rays.items()} for i in range(3)]
    n_c, n_f = pipe.n_coarse, pipe.n_fine
    ops, bound_ms = nerf_step_bound(pipe, b)
    log(f"[{tag}] {b} rays a step, {n_c} + {n_f} samples, L_x {pipe.L_x}, L_d {pipe.L_d}, "
        f"width {config['pipeline']['mlp_hidden_dim']}, include_height "
        f"{config['pipeline']['include_height']}: {sum(p.numel() for p in pipe.parameters())} "
        f"parameters; one step's GEMMs {ops / 1e12:.3f} TFLOP = {bound_ms:.2f} ms at the "
        f"float32 peak ({1e3 * b / bound_ms:.0f} rays/s)")
    if full:
        nerf_card_vs_cpu(tag, config, ds, pipe, batches[2])
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(tcfg, ds, pipe, f"chip_smoke_{tag}", data_root=root, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        fwd_s, eval_before = [], []
        for i in range(3 if full else 0):
            t0 = time.perf_counter()
            with torch.no_grad():
                out = pipe(batches[i])
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
            eval_before.append(float(pipe.compute_loss(batches[i], out)))
            for k, shp in (("color_map_fine", (b, 4)), ("z_vals_fine", (b, n_c + n_f)),
                           ("weights_coarse", (b, n_c, 1)), ("sigma_fine", (b, n_c + n_f, 4))):
                if tuple(out[k].shape) != shp or not torch.isfinite(out[k]).all():
                    raise RuntimeError(f"[{tag}] {k}: shape {tuple(out[k].shape)}, want {shp}, "
                                       "or not finite")
        losses = []
        t0 = time.perf_counter()
        for _ in trainer.iterate(Path(root) / "output"):
            losses.append(trainer.last_loss)
        torch.cuda.synchronize()
        iterate_s = time.perf_counter() - t0
        n_ckpt = len(list((Path(root) / "output").glob("epoch_*.pt")))
        sigma = grid = None
        if full:
            with torch.no_grad():
                eval_after = [float(pipe.compute_loss(bt, pipe(bt))) for bt in batches]
            grid = get_extract_dataset("voxelgrid", ds, horizontal_step=3000.0, alt_step=250.0)
            t0 = time.perf_counter()
            sigma = run_extraction(pipe, grid, batch_size=EXTRACT_BATCH)
            extract_s = time.perf_counter() - t0
        counts = read_counts()
        # ---- end of the main path ----
        peak_mib = torch.cuda.max_memory_allocated() / 2**20

    if launched(counts):
        raise RuntimeError(f"[{tag}] a hash-grid kernel launched on the NeRF path: {show(counts)}")
    loss = torch.stack(losses).cpu()
    if trainer.iter_count != steps or loss.shape != (steps,) or not bool(torch.isfinite(loss).all()):
        raise RuntimeError(f"[{tag}] ran {trainer.iter_count} steps; losses finite: "
                           f"{bool(torch.isfinite(loss).all())}")
    k = max(1, steps // 4)
    first, last = float(loss[:k].mean()), float(loss[-k:].mean())
    log(f"[{tag}] {steps} steps through Trainer.iterate ({trainer.steps_per_epoch} a epoch, "
        f"{n_ckpt} checkpoints): loss first {k} {first:.4f}, last {k} {last:.4f}; "
        f"{1e3 * iterate_s / steps:.2f} ms per step with epoch ends; peak device memory "
        f"{peak_mib:.0f} MiB; launches on the path: {show(counts)}; on {card}")
    if not full:
        return counts
    # The step losses are each a new batch's: on this granule their spread
    # (~42 a batch at init; radiances average ~33, the colors are at most e)
    # is as large as the fall the model can make, so the fall is held on the
    # deterministic loss of the same three batches before and after the steps
    before, after = statistics.mean(eval_before), statistics.mean(eval_after)
    log(f"[{tag}] the deterministic loss of the first three batches ({3 * b} rays): "
        f"{before:.4f} before the steps, {after:.4f} after; the step losses' spread "
        f"at init: {statistics.pstdev(float(x) for x in loss[:k]):.4f}")
    if not after < before:
        raise RuntimeError(f"[{tag}] the loss did not fall: {before} -> {after}")
    med_fwd = statistics.median(fwd_s[1:])
    log(f"[{tag}] deterministic forward of {b} rays (median of 2 after the first): "
        f"{med_fwd * 1e3:.2f} ms = {b / med_fwd:.0f} rays/s; all three: "
        + ", ".join(f"{x * 1e3:.2f}" for x in fwd_s) + " ms")
    n = len(grid)
    if (sigma.shape != (n, 4) or not np.all(np.isfinite(sigma)) or np.any(sigma < 0)
            or not float(sigma.max()) > 0):
        raise RuntimeError(f"[{tag}] voxelgrid sigma not finite, non-negative, (N, 4)")
    log(f"[{tag} extract voxelgrid] {n} points, shape {grid.shp}: run_extraction "
        f"{extract_s:.3f} s = {n / extract_s:.0f} points/s in ceil({n}/{EXTRACT_BATCH}) batches; "
        f"sigma (N, 4), max {float(sigma.max()):.3g} m^-1; on {card}")

    per = steady_step_s(trainer, 2, 8)
    med = statistics.median(per)
    log(f"[steady] {tag} train step of {b} rays (median of 2 blocks of 8 steps): "
        f"{med * 1e3:.2f} ms = {b / med:.0f} rays/s, min {min(per) * 1e3:.2f}, max "
        f"{max(per) * 1e3:.2f} ms; the GEMM bound {bound_ms:.2f} ms is {bound_ms / (med * 1e3):.1%} "
        f"of it; on {card}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(torch.arange(b, device=pipe.device))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, by_name, _ = log_profile(prof, f"{tag} train step", med * 1e6, wall_us, card,
                                      top=8)
    gemm_us = sum(t for name, t in by_name.items()
                  if any(w in name.lower() for w in ("gemm", "xmma", "cutlass", "cublas")))
    log(f"[profile] {tag}: GEMM kernels {gemm_us:.0f} us = {gemm_us / busy_us:.1%} of the device "
        f"busy time; at the float32 peak they would take {bound_ms * 1e3:.0f} us")
    return counts


def phase_nerf(ds, card: str) -> dict:
    """``configs/nerf.json`` unchanged at full width (4,096 rays, 64 + 128
    samples, 256 wide) on the flagship's granule: ``NERF_STEPS`` steps and
    the rest of ``run_nerf``. Returns the counts by path."""
    from atmonr_tpu_torch import load_config

    config = load_config(CONFIGS / "nerf.json")
    counts = run_nerf("N nerf", config, ds, card, steps=NERF_STEPS, full=True)
    torch.cuda.empty_cache()
    return {"N nerf": counts}


def phase_include_height(ds, card: str) -> dict:
    """The height channel: ``nerf.json`` and ``instant_ngp_tpu.json`` (uniform
    sampler) with ``include_height`` true and no preprocessor, set in memory
    (NeRF's ``L_x`` gains a 4th entry of 10), ``HEIGHT_STEPS`` steps each
    with finite losses; the Instant-NGP position grid is 4-D and takes no
    kernel, its surface grid K1 bf16 and K2 D=2. Returns the counts by
    path."""
    import warnings

    from atmonr_tpu_torch import load_config

    config = load_config(CONFIGS / "nerf.json")
    config["pipeline"].update(include_height=True, point_preprocessor=None)
    config["pipeline"]["encoder"]["L_x"] = config["pipeline"]["encoder"]["L_x"] + [10]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a varying L_x without a preprocessor
        paths = {"H nerf": run_nerf("H nerf", config, ds, card, steps=HEIGHT_STEPS, full=False)}
    torch.cuda.empty_cache()
    config = load_config(CONFIGS / "instant_ngp_tpu.json")
    config["pipeline"].update(include_height=True, point_preprocessor=None)
    r = run_config("H instant_ngp", config, ds, card, steps=HEIGHT_STEPS, steady=(1, 4))
    if r["pipe"].pos_cfg.n_dims != 4:
        raise RuntimeError("include_height did not give a 4-D position grid")
    paths["H instant_ngp"] = r["counts"]
    del r
    torch.cuda.empty_cache()
    return paths


def _table_rel_l2(a, b) -> dict[str, float]:
    """Per hash table of two pipelines, ||a - b|| / ||b||."""
    pb = dict(b.named_parameters())
    return {
        name: float(torch.linalg.vector_norm(p - pb[name]) / torch.linalg.vector_norm(pb[name]))
        for name, p in a.named_parameters() if name == "pos_table" or name.startswith("surf_enc")
    }


def phase_multi_device(ctx: dict, card: str) -> dict:
    """The multi-device paths on the one card, in one process joined to an
    NCCL process group of one rank through a ``FileStore`` in a temporary
    directory (no network; NCCL refuses two ranks on one card, so every
    collective here is of one rank):

    1. ``Trainer.shard(make_mesh_from_spec("data=1"))`` on the flagship at
       full width: ``MULTI_STEPS`` steps on the same rays and draws as an
       unsharded Trainer of the same seed (losses to rtol 1e-5, hash tables
       within ``MULTI_TABLE_REL_L2``, K1 and K2 launches a step the same),
       then ``MULTI_BLOCKS`` blocks of ``BLOCK`` steady steps of each in
       turns (unsharded, sharded, sharded, unsharded), one profiled sharded
       step, and the NCCL all-reduce of the
       gradient's flat buffer alone (device and host time; the step skips it
       on an axis of one rank);
    2. two granules of ``synthetic:128x64x2`` (Trainer seeds 0 and 1, as the
       train CLI seeds granules) through ``train_granules`` on the card,
       ``GRANULE_STEPS`` steps each: finite losses falling in each, granule
       0's tables against a lone Trainer of seed 0 within
       ``GRANULE_SPREADS`` times the distance between two lone Trainers of
       seed 0, twice a lone Trainer's launches, and the combined rays/s
       beside the lone Trainer's;
    3. ``run_extraction(..., mesh)`` on the extract phase's voxelgrid of the
       trained flagship: sigma equal to the unsharded query's bit for bit,
       K1 launched ceil(N / 32,768) times.

    Each path's counts are set to 0 just before it and read just after.
    Returns the counts by path."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from atmonr_tpu_torch import Trainer, get_dataset, get_pipeline, run_extraction
    from atmonr_tpu_torch.parallel.mesh import make_mesh_from_spec, mesh_axes
    from atmonr_tpu_torch.training.multi import train_granules

    config, ds, paths = ctx["config"], ctx["ds"], {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group("nccl", store=dist.FileStore(f"{root}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = make_mesh_from_spec("data=1")

            def trainer(name, seed=0, dataset=ds, **over):
                pipe = get_pipeline(config["pipeline"], dataset)
                tcfg = dict(config["trainer"], **over)
                return Trainer(tcfg, dataset, pipe, name, data_root=root, seed=seed)

            # ---- 1. the data-sharded flagship against the unsharded one ----
            plain, sharded = trainer("plain"), trainer("mesh")
            sharded.shard(mesh)
            perm = torch.randperm(sharded.rank_rays, device=ds.device,
                                  generator=torch.Generator(ds.device).manual_seed(5))
            gen = torch.Generator(ds.device).manual_seed(6)
            batches = [(perm[i * BATCH:(i + 1) * BATCH],
                        plain.pipeline.make_draws(BATCH, gen)) for i in range(MULTI_STEPS)]
            reset_counts()
            want = torch.stack([plain.step(idx, draws) for idx, draws in batches]).cpu()
            plain_counts = read_counts()
            # ---- the main path: counts reset just before, read just after ----
            reset_counts()
            got = torch.stack([sharded.step(idx, draws) for idx, draws in batches]).cpu()
            paths["multi-device data=1"] = read_counts()
            # ---- end of the main path ----
            rel = _table_rel_l2(sharded.pipeline, plain.pipeline)
            log(f"[multi data=1] {MULTI_STEPS} steps of {BATCH} rays on an NCCL mesh of one "
                f"rank against the unsharded Trainer, same rays and draws: losses "
                f"{[round(float(x), 6) for x in got]}, max rel diff "
                f"{float(((got - want).abs() / want.abs()).max()):.3g}; hash tables' relative "
                f"L2 {', '.join(f'{k} {v:.3g}' for k, v in rel.items())}; launches "
                f"{show(paths['multi-device data=1'])} (unsharded {show(plain_counts)})")
            if not torch.allclose(got, want, rtol=1e-5, atol=0):
                raise RuntimeError(f"sharded losses {got} differ from the unsharded {want}")
            if max(rel.values()) > MULTI_TABLE_REL_L2:
                raise RuntimeError(f"sharded tables differ from the unsharded ones: {rel}")
            if launched(paths["multi-device data=1"]) != launched(plain_counts) or \
                    launched(plain_counts) != step_counts("q8", MULTI_STEPS):
                raise RuntimeError("the sharded step's launches differ from the unsharded one's")
            sh, pl = [], []
            for _ in range(MULTI_BLOCKS // 2):  # unsharded, sharded, sharded, unsharded
                pl += steady_step_s(plain, 1, BLOCK)
                sh += steady_step_s(sharded, 2, BLOCK)
                pl += steady_step_s(plain, 1, BLOCK)
            log(f"[steady] multi data=1 train step of {BATCH} rays, {MULTI_BLOCKS} blocks of "
                f"{BLOCK} steps each, in turns (unsharded, sharded, sharded, unsharded): sharded "
                f"median "
                f"{statistics.median(sh) * 1e3:.2f} ms (min {min(sh) * 1e3:.2f}, max "
                f"{max(sh) * 1e3:.2f}), unsharded {statistics.median(pl) * 1e3:.2f} ms (min "
                f"{min(pl) * 1e3:.2f}, max {max(pl) * 1e3:.2f}), on {card}")
            # the host cost of DeviceMesh's accessors, which the Trainer
            # reads once, at shard (mesh_axes), not on every step
            cost = {}
            for what, fn in (("mesh.mesh", lambda: mesh.mesh), ("mesh.shape", lambda: mesh.shape),
                             ("get_local_rank", lambda: mesh.get_local_rank("data")),
                             ("mesh_axes", lambda: mesh_axes(mesh))):
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                cost[what] = (time.perf_counter() - t0) / 200 * 1e6
            log(f"[multi data=1] host us a call, DeviceMesh accessors: "
                f"{', '.join(f'{k} {v:.1f}' for k, v in cost.items())}, on {card}")
            idx, draws = batches[0]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sharded.step(idx, draws)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            log_profile(prof, "multi data=1 train step", statistics.median(sh) * 1e6, wall_us,
                        card, top=6)
            # the step skips the gradient all-reduce on an axis of one rank:
            # here is what one costs, on the same flat buffer (the gradient
            # and the loss), over the data group
            flat = torch.zeros(sum(p.numel() for p in sharded.pipeline.parameters()) + 1,
                               device=ds.device)
            group = mesh.get_group("data")
            dist.all_reduce(flat, group=group)  # the communicator's set-up
            torch.cuda.synchronize()
            host_us = []
            for _ in range(20):
                t0 = time.perf_counter()
                dist.all_reduce(flat, group=group)
                host_us.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                dist.all_reduce(flat, group=group)
                torch.cuda.synchronize()
            nccl = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.device_time_total > 0]
            log(f"[profile] multi data=1 gradient all-reduce of {flat.numel()} floats over an "
                f"NCCL group of one rank (the step skips it there): device "
                f"{sum(e.device_time_total for e in nccl):.1f} us in {len(nccl)} kernels "
                f"({', '.join(sorted({e.name[:50] for e in nccl})) or 'none'}); host median "
                f"{statistics.median(host_us):.1f} us a call (min {min(host_us):.1f}), on {card}")
            del plain, sharded, batches, flat
            torch.cuda.empty_cache()

            # ---- 2. two granules on the one card ----
            granules = [trainer(f"granule{g}", seed=g, dataset=get_dataset(
                config["dataset"], SCENE), num_iters=GRANULE_STEPS) for g in range(2)]
            losses = [[] for _ in granules]
            for t, record in zip(granules, losses):
                def step(*args, _step=t.step, _record=record, **kwargs):
                    _record.append(_step(*args, **kwargs))
                    return _record[-1]
                t.step = step
                t.place(torch.device("cuda", torch.cuda.current_device()))
            outs = [Path(root) / f"granule_{g}" for g in range(2)]
            torch.cuda.synchronize()
            # ---- the main path: counts reset just before, read just after ----
            reset_counts()
            t0 = time.perf_counter()
            train_granules(granules, outs)
            torch.cuda.synchronize()
            both_s = time.perf_counter() - t0
            paths["multi-device granules"] = read_counts()
            # ---- end of the main path ----
            # two lone Trainers of seed 0: the second gives the spread of the
            # tables between two runs of the same steps (K2's float atomics)
            lones, lone_s = [], []
            for k in range(2):
                lones.append(trainer(f"lone{k}", seed=0, num_iters=GRANULE_STEPS,
                                     dataset=get_dataset(config["dataset"], SCENE)))
                reset_counts()
                t0 = time.perf_counter()
                lones[-1].train(Path(root) / f"lone{k}")
                torch.cuda.synchronize()
                lone_s.append(time.perf_counter() - t0)
                lone_counts = read_counts()
            q = GRANULE_STEPS // 4
            for g, record in enumerate(losses):
                loss = torch.stack(record).cpu()
                first, last = float(loss[:q].mean()), float(loss[-q:].mean())
                log(f"[multi granules] granule {g}: {len(loss)} steps, loss first quarter "
                    f"{first:.4f}, last quarter {last:.4f}, {granules[g].epoch_idx} epochs")
                if not (bool(torch.isfinite(loss).all()) and last < first):
                    raise RuntimeError(f"granule {g}'s loss did not fall: {first} -> {last}")
            rel = _table_rel_l2(granules[0].pipeline, lones[0].pipeline)
            spread = _table_rel_l2(lones[1].pipeline, lones[0].pipeline)
            bound = {k: max(MULTI_TABLE_REL_L2, GRANULE_SPREADS * v) for k, v in spread.items()}
            want = {k: 2 * n for k, n in launched(lone_counts).items()}
            rays = GRANULE_STEPS * BATCH
            log(f"[multi granules] 2 granules x {GRANULE_STEPS} steps of {BATCH} rays through "
                f"train_granules on one card in {both_s:.2f} s = {2 * rays / both_s:.0f} rays/s "
                f"together; a lone Trainer {lone_s[0]:.2f}, {lone_s[1]:.2f} s = "
                f"{rays / lone_s[0]:.0f}, {rays / lone_s[1]:.0f} rays/s (all with epoch ends "
                f"and checkpoints), on {card}; tables' relative L2, granule 0 against a lone "
                f"Trainer of seed 0: {', '.join(f'{k} {v:.3g}' for k, v in rel.items())}; "
                f"two lone Trainers of seed 0: "
                f"{', '.join(f'{k} {v:.3g}' for k, v in spread.items())}; launches "
                f"{show(paths['multi-device granules'])}")
            if launched(paths["multi-device granules"]) != want:
                raise RuntimeError(f"granule launches {show(paths['multi-device granules'])}, "
                                   f"expected twice the lone Trainer's {show(lone_counts)}")
            if any(rel[k] > bound[k] for k in rel):
                raise RuntimeError(f"granule 0 differs from the lone Trainer by {rel}, more than "
                                   f"{bound}")
            del granules, lones
            torch.cuda.empty_cache()

            # ---- 3. the extraction over the mesh ----
            grid, pipe = ctx["voxelgrid"], ctx["extract_pipe"]
            t0 = time.perf_counter()
            one = run_extraction(pipe, grid, batch_size=EXTRACT_BATCH)
            one_s = time.perf_counter() - t0
            # ---- the main path: counts reset just before, read just after ----
            reset_counts()
            t0 = time.perf_counter()
            sigma = run_extraction(pipe, grid, batch_size=EXTRACT_BATCH, mesh=mesh)
            query_s = time.perf_counter() - t0
            paths["multi-device extract"] = read_counts()
            # ---- end of the main path ----
            n = len(grid.xyz)
            want = encodes("q8", -(-n // EXTRACT_BATCH))
            log(f"[multi extract] run_extraction over the mesh of one rank, voxelgrid of {n} "
                f"points in {query_s:.3f} s = {n / query_s:.0f} points/s (unsharded just before "
                f"{one_s:.3f} s), on {card}; equal to the unsharded query bit for bit: "
                f"{np.array_equal(sigma, one)}; launches {show(paths['multi-device extract'])}")
            if not np.array_equal(sigma, one):
                raise RuntimeError("the mesh's extraction differs from the unsharded one")
            if launched(paths["multi-device extract"]) != want:
                raise RuntimeError(f"extract launches {show(paths['multi-device extract'])}, "
                                   f"expected {show(want)}")
        finally:
            dist.destroy_process_group()
    log(f"[time] {time.perf_counter() - t_phase:.1f} s in the multi-device phase")
    return paths


def t2_row(dma: dict) -> dict:
    """T2's row of the kernels line from ``tools.bench_dma_gather``'s results
    on ``T2_TABLES``: its own numbers those of single rows from beyond the L2,
    as K1 gathers them at 2^21, and every table and ``rpd`` under
    ``shapes``."""
    shapes = []
    for label, tile_rows in T2_TABLES:
        by_name = {r["name"]: r for r in dma[label]["results"]}
        for rpd in T2_RPDS:
            r = by_name[f"block_fetch_{rpd}tile"]
            shapes.append({"tile_rows": tile_rows, "rpd": rpd, "max_abs_err": r["max_abs_err"],
                           "ms": r["device_ms"], "call_ms": r["ms"], "plain_ms": r["plain_ms"],
                           "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                           "bound_by": r["bound_by"]})
    main_shape = next(r for r in shapes if r["tile_rows"] == T2_TABLES[1][1] and r["rpd"] == 1)
    return {
        "name": "block_fetch (T2, 512-byte rows, 1 row a run, 330,339-row table)",
        "route": "cuda", "source": T2_SOURCE, "replaces": T2_REPLACES,
        "key": [("T2", None, rpd) for rpd in T2_RPDS], "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in shapes), "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
        "shapes": shapes,
    }


def phase_tools(ctx: dict, card: str, rows: list[dict]) -> dict:
    """The tools path, every count set to 0 just before it and read just
    after: ``tools.bench_dma_gather`` on both ``T2_TABLES`` (which holds T2
    to its plain version at ``T2_RPDS`` and times it: T2's row of the kernels
    line), the port's bench
    (``atmonr_tpu_torch.bench.main`` with its own constants), ``profile_step``
    on the flagship, ``diag_fwd_breakdown``, ``bench_trainer`` over two
    timed epochs and ``bench_scaling`` at ``data=1`` (NCCL, one rank).
    Returns the counts by path."""
    from atmonr_tpu_torch import bench
    from atmonr_tpu_torch.tools import (
        bench_dma_gather, bench_scaling, bench_trainer, diag_fwd_breakdown, profile_step,
    )

    t_phase = time.perf_counter()
    # ---- the tools path: counts reset just before, read just after ----
    reset_counts()
    dma = {label: bench_dma_gather.main(["--tile-rows", str(tile_rows)])
           for label, tile_rows in T2_TABLES}
    rays_s = bench.main()
    stages = profile_step.main([str(CONFIG.relative_to(REPO))])
    diag = diag_fwd_breakdown.main()
    trainer = bench_trainer.main(["epochs=2"])
    scaling = bench_scaling.main(["data=1"], max_warm_iters=SCALING_WARM_ITERS)
    counts = read_counts()
    # ---- end of the tools path ----

    log(f"[tools] launches on the tools path: {show(counts)}")
    rows.append(t2_row(dma))
    for k in [("T2", None, rpd) for rpd in T2_RPDS] + [("K1", "q8", 3), ("K1p", "q8", 3),
                                                         ("K2", None, 3)]:
        if not counts[k]:
            raise RuntimeError(f"{k} was not launched on the tools path")
    for label, out in dma.items():
        by_name = {r["name"]: r for r in out["results"]}
        wide = by_name["index_select_f32_row512B"]
        wide_gb = wide["rows_per_s"] * (2 * 512 + 4) / 1e9
        fetch = ", ".join(f"rpd {rpd} {by_name[f'block_fetch_{rpd}tile']['gb_per_s']:.1f} GB/s"
                          for rpd in T2_RPDS)
        log(f"[tools] {label} ({out['table_rows'] * 8 / 1e6:.1f} MB table): index_select of "
            f"512-byte rows {wide_gb:.1f} GB/s per call with launch; block fetch device "
            f"{fetch}; beside 3.35 TB/s, on {card}")
    steady = ctx.get("steady_rays_s")
    log(f"[tools] the port's bench {rays_s:.0f} rays/s (its last JSON line above) beside the "
        f"flagship Trainer's [steady] {steady:.0f} rays/s: {rays_s / steady:.3f}x, on {card}")
    q8 = diag["q8 prepare_table noise"]["device_ms"] / diag["q8 hash_encode"]["device_ms"]
    log(f"[tools] profile_step: encode fwd {stages['encode_fwd'] * 1e3:.2f} ms, fwd+bwd "
        f"{stages['encode_fwd_bwd'] * 1e3:.2f}, forward {stages['forward'] * 1e3:.2f}, grad "
        f"{stages['grad'] * 1e3:.2f}, step {stages['step'] * 1e3:.2f}; q8 quantizer with noise "
        f"{q8:.1%} of a q8 encode's device time (diag_fwd_breakdown); bench_trainer in-epoch "
        f"{trainer['in_epoch_rays_per_s']:.0f}, overall {trainer['overall_rays_per_s']:.0f} "
        f"rays/s, epoch end {trainer['epoch_sync_s']:.3f} s; bench_scaling data=1 "
        f"{scaling['data=1']:.0f} rays/s")
    log(f"[time] {time.perf_counter() - t_phase:.1f} s in the tools phase")
    return {"tools": counts}


def _cell_counts(mode: str, iters: int, refresh_every: int, slices: int) -> dict:
    """The launches of one ``ab_importance.run`` cell: ``iters`` steps, the
    Trainer's refresh after every ``refresh_every``-th step (none without a
    grid), and the eval's ``slices`` deterministic forwards."""
    refreshes = iters // refresh_every if refresh_every else 0
    return step_counts(mode, iters, k1_d3_extra=refreshes + slices, k1_d2_extra=slices)


def _add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in a.keys() | b.keys()}


def _untrained(path: str, ds) -> tuple[dict, str, dict]:
    """PSNR/SSIM of a cell's initial parameters (seed 0, as ``run`` draws
    them) over every ray of ``ds``, the kernels' mode and the launches of
    that eval."""
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.models import hash_grid as hg
    from atmonr_tpu_torch.tools import ab_importance, repo_path

    cfg = load_config(repo_path(path))
    pipe = get_pipeline(cfg["pipeline"], ds, generator=torch.Generator().manual_seed(0))
    mode = hg.resolve_fwd_mode(pipe.pos_cfg)
    t0 = time.perf_counter()
    m = ab_importance.evaluate(pipe, ds)
    m["eval_s"] = time.perf_counter() - t0
    slices = ab_importance.eval_slices(ds.num_rays)
    return m, mode, encodes(mode, slices, slices)


def phase_quality(ctx: dict, card: str, rows: list[dict]) -> dict:
    """The quality and real-scale path, every count set to 0 just before it
    and read just after, each part's launches held to what its sampler
    implies: ``tools.real_scale_demo`` at full size from memory (the
    flagship, 1 + 59 + 200 steps, the voxelgrid query), one
    ``quality_real_scale`` cell of the flagship on that dataset
    (``ab_importance.run``, ``REAL_CELL_BUDGET`` s, seed 0, eval over every
    ray) beside its initial parameters' eval, then ``tools.quality_matrix``
    on ``QM_VARIANTS`` x ``QM_SCENES`` beside each cell's untrained eval.
    Every trained PSNR must beat its untrained one, every loss be finite.
    Then K1 and K2 against their plain versions at the real-scale path's
    own points."""
    from atmonr_tpu_torch import load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.tools import (
        ab_importance, quality_matrix, quality_real_scale, real_scale_demo, repo_path,
    )

    t_phase = time.perf_counter()
    flagship = quality_real_scale.VARIANTS["occ13_32p24f"]
    every = json.loads(CONFIG.read_text())["pipeline"]["occupancy"]["update_every"]
    # ---- the quality path: counts reset just before, read just after ----
    reset_counts()
    keep = {}
    demo = real_scale_demo.main(REAL_DEMO_ARGS, keep=keep)
    after_demo = read_counts()
    ds = keep["dataset"]
    cell = ab_importance.run("occ13_32p24f", flagship, quality_real_scale.MAX_ITERS, seed=0,
                             seconds=REAL_CELL_BUDGET, dataset=ds)
    init, _, init_counts = _untrained(flagship, ds)
    after_cell = read_counts()
    with tempfile.TemporaryDirectory() as tmp:
        qm = quality_matrix.main([f"budget={QM_BUDGET}", "seeds=0", f"variants={QM_VARIANTS}",
                                  f"scenes={QM_SCENES}", f"out={tmp}/quality_matrix.jsonl"])
    qm_init = {}
    want_qm = {}
    for r in qm:
        path = quality_matrix.VARIANTS[r["name"]]
        cfg = load_config(repo_path(path))
        qds = HARP2Dataset(cfg["dataset"], make_synthetic_granule(
            **ab_importance.GRANULE, n_blobs=quality_matrix.SCENES[r["scene"]]))
        m, mode, c = _untrained(path, qds)
        qm_init[r["name"], r["scene"]] = m
        grid = cfg["pipeline"].get("occupancy")
        want_qm = _add(want_qm, _add(c, _cell_counts(
            mode, r["iters"], grid["update_every"] if grid else 0,
            ab_importance.eval_slices(qds.num_rays))))
    counts = read_counts()
    # ---- end of the quality path ----

    dev_mem = demo["device_memory"]
    log(f"[real scale] {demo['height']}x{demo['width']} pixels x 90 views from memory: "
        f"granule {demo['granule_mb']} MB built in {demo['granule_s']} s; {demo['num_rays']} "
        f"rays (the JAX harness's record: {JAX_REAL_RAYS}; equal: "
        f"{demo['num_rays'] == JAX_REAL_RAYS}), ray store {demo['ray_store_mb']} MB, dataset "
        f"built in {demo['dataset_build_s']} s")
    log(f"[real scale] flagship train step at {BATCH} rays with every ray on the card: steady "
        f"{demo['steady_rays_per_s']:.0f} rays/s over {demo['steps']} steps beside phase 6's [steady] "
        f"{ctx['steady_rays_s']:.0f} rays/s ({demo['steady_rays_per_s'] / ctx['steady_rays_s']:.3f}"
        f"x); first step {demo['compile_s']} s; loss {demo['final_loss']:.4f}; peak device memory "
        f"{dev_mem['max_allocated_mb']:.0f} MB allocated, {dev_mem['free_mb']:.0f} of "
        f"{dev_mem['total_mb']:.0f} MB free after; voxelgrid {demo['extract_points']} points in "
        f"{demo['extract_s']} s, on {card}")
    n_extract = -(-demo["extract_points"] // BATCH)
    want_demo = step_counts("q8", keep["steps"],
                            k1_d3_extra=keep["steps"] // every + n_extract)
    if launched(after_demo) != want_demo:
        raise RuntimeError(f"[real scale] launches: {show(after_demo)}; expected {show(want_demo)}")
    log(f"[real scale] launches of the demo: {show(after_demo)}")

    slices = ab_importance.eval_slices(ds.num_rays)
    log(f"[real scale] quality cell occ13_32p24f seed 0, {REAL_CELL_BUDGET:.0f} s: "
        f"{cell['iters']} steps ({cell['rays_per_s']:.0f} rays/s, {cell['restarts']} "
        f"restarts), loss {cell['loss']:.5f}; PSNR {cell['psnr']:.3f} SSIM {cell['ssim']:.4f} "
        f"over all {ds.num_rays} rays ({slices} slices of {ab_importance.EVAL_SLICE}) in "
        f"{cell['eval_s']:.1f} s; the initial parameters: PSNR {init['PSNR_mean']:.3f} SSIM "
        f"{init['SSIM_mean']:.4f} in {init['eval_s']:.1f} s, on {card}")
    if not np.isfinite(cell["loss"]) or not cell["psnr"] > init["PSNR_mean"]:
        raise RuntimeError(f"[real scale] quality cell: loss {cell['loss']}, PSNR "
                           f"{cell['psnr']} against the initial {init['PSNR_mean']}")
    delta = {k: after_cell[k] - after_demo[k] for k in after_cell}
    want_cell = _add(_cell_counts("q8", cell["iters"], every, slices), init_counts)
    if launched(delta) != launched(want_cell):
        raise RuntimeError(f"[real scale] quality cell launches: {show(delta)}; expected "
                           f"{show(want_cell)}")

    for r in qm:
        m = qm_init[r["name"], r["scene"]]
        log(f"[quality] {r['name']} {r['scene']} seed 0, {QM_BUDGET:.0f} s: {r['iters']} steps "
            f"({r['rays_per_s']:.0f} rays/s), loss {r['loss']:.5f}, PSNR {r['psnr']:.3f} SSIM "
            f"{r['ssim']:.4f}; untrained PSNR {m['PSNR_mean']:.3f} SSIM {m['SSIM_mean']:.4f}; "
            f"eval {r['eval_s']:.2f} s, on {r['device']}")
        if not np.isfinite(r["loss"]) or not r["psnr"] > m["PSNR_mean"]:
            raise RuntimeError(f"[quality] {r['name']} {r['scene']}: loss {r['loss']}, PSNR "
                               f"{r['psnr']} against the untrained {m['PSNR_mean']}")
    delta = {k: counts[k] - after_cell[k] for k in counts}
    if launched(delta) != launched(want_qm):
        raise RuntimeError(f"[quality] matrix launches: {show(delta)}; expected {show(want_qm)}")
    log(f"[quality] launches on the quality path: {show(counts)}")

    batch = {k: v[:BATCH] for k, v in ds.rays().items()}
    check_path_kernels("quality real scale", keep["pipeline"], batch, rows)
    log(f"[time] {time.perf_counter() - t_phase:.1f} s in the quality phase")
    return {"quality": counts}


def phase_collapse(card: str) -> dict:
    """The collapse tool's cells (``COLLAPSE_CELLS``: the JAX package's and the
    port's inits of seeds 0 and 4) on ``COLLAPSE_CONFIG``, the smooth scene,
    ``COLLAPSE_STEPS`` steps each at bf16 MLP products, every count set to 0
    just before and read just after; raises on a non-finite loss or a launch
    count other than the cells' steps, refreshes and eval slices imply."""
    from atmonr_tpu_torch import load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.tools import ab_importance, repo_path
    from atmonr_tpu_torch.tools import repro_occ15_collapse as collapse
    from atmonr_tpu_torch.utils.device import resolve_device

    t_phase = time.perf_counter()
    dev = resolve_device(None)
    cfg = load_config(repo_path(COLLAPSE_CONFIG))
    ds = HARP2Dataset(cfg["dataset"], make_synthetic_granule(**collapse.GRANULE, n_blobs=1),
                      device=dev)
    every = cfg["pipeline"]["occupancy"]["update_every"]
    want = {}
    reset_counts()
    rows = []
    for init, seed in COLLAPSE_CELLS:
        row = collapse.run_cell(cfg, ds, seed, init=init, products="bf16",
                                num_iters=COLLAPSE_STEPS, device=dev)
        if not np.isfinite(row["loss_final"]) or not all(np.isfinite(t[1]) for t in row["trace"]):
            raise RuntimeError(f"[collapse] init={init} seed={seed}: a non-finite loss")
        rows.append(row)
        want = _add(want, _cell_counts("q8", COLLAPSE_STEPS, every,
                                       ab_importance.eval_slices(ds.num_rays)))
    counts = read_counts()
    if launched(counts) != launched(want):
        raise RuntimeError(f"collapse launches {show(counts)}, want {show(want)}")
    for row in rows:
        at = row["loss_at_check"]
        log(f"[collapse] {COLLAPSE_CONFIG} init={row['init']} seed={row['seed']}: "
            f"{'collapsed' if row['collapsed_at_check'] else 'healthy'} at step "
            f"{collapse.CHECK_ITER} (mean of the last 5 losses "
            f"{'none' if at is None else f'{at:.5f}'}), "
            f"final loss {row['loss_final']:.5f}, atmosphere gradient 0 from step "
            f"{row['atmosphere_dead_from']}, surface from {row['surface_dead_from']}, PSNR "
            f"{row['psnr']:.2f} SSIM {row['ssim']:.4f}, {row['seconds']:.2f} s, on {card}")
    jax_rows = {r["seed"]: r["collapsed_at_check"] for r in rows if r["init"] == "jax"}
    log(f"[collapse] the JAX package's inits on the card: seed 4 "
        f"{'collapsed' if jax_rows[4] else 'healthy'}, seed 0 "
        f"{'collapsed' if jax_rows[0] else 'healthy'} (the TPU record: seed 4 collapsed, "
        f"seed 0 healthy); launches {show(counts)}")
    log(f"[time] {time.perf_counter() - t_phase:.1f} s in the collapse phase")
    return {"collapse": counts}


def phase_entry(card: str, rows: list[dict]) -> dict:
    """``graft_entry.entry()`` on the card against the CPU's, and
    ``graft_entry.dryrun_multichip`` over NCCL on every card present, each
    path's counts set to 0 just before it and read just after (the dry
    run's from its ranks' own counts). K1 and K2 are held against their
    plain versions on the entry's card pipeline (the dry run's tiny config
    and tables) at the entry's 64 rays and at the dry run's 8 rays a rank."""
    from atmonr_tpu_torch import graft_entry

    t_phase = time.perf_counter()
    reset_counts()
    fn, (pipe, batch) = graft_entry.entry()
    with torch.no_grad():
        loss, color = fn(pipe, batch)
        torch.cuda.synchronize()
    entry_counts = read_counts()
    want = encodes("bf16", 1, 1)
    if launched(entry_counts) != want:
        raise RuntimeError(f"entry() launched {show(entry_counts)}, want {show(want)}")
    cfn, (cpipe, cbatch) = graft_entry.entry(device="cpu")
    with torch.no_grad():
        closs, ccolor = cfn(cpipe, cbatch)
    color = color.cpu()
    err = float((color - ccolor).abs().max() / ccolor.abs().max())
    rel = abs(float(loss) / float(closs) - 1.0)
    log(f"[entry] forward and loss on {graft_entry.ENTRY_RAYS} rays of the 12x8 granule at "
        f"the JAX entry's parameters: loss {float(loss):.6f} (CPU {float(closs):.6f}, rel diff "
        f"{rel:.2g}), colors {tuple(color.shape)} max |diff| {err:.2g} of the largest "
        f"(limits rtol 1e-3 on the loss, 1e-3 + 1e-4 of the largest on the colors: bf16 "
        f"products and float32 preprocessors of two devices); launches {show(entry_counts)}")
    if not torch.isfinite(color).all() or rel > 1e-3 or not torch.allclose(
            color, ccolor, rtol=1e-3, atol=1e-4 * float(ccolor.abs().max())):
        raise RuntimeError("entry() on the card differs from the CPU's")
    check_path_kernels("entry", pipe, batch, rows)
    check_path_kernels("entry dryrun", pipe, {k: v[:8] for k, v in batch.items()}, rows)
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = graft_entry.dryrun_multichip(n)
    dry_s = time.perf_counter() - t0
    counts = dict.fromkeys(read_counts(), 0)  # every kernel's key, T2's among them
    for r in ranks:
        counts = _add(counts, {("K1", mode, d): c for (mode, d), c in r["launches"]["K1"].items()})
        counts = _add(counts, {("K2", None, d): c for d, c in r["launches"]["K2"].items()})
    need = [("K1", "bf16", 3), ("K1", "bf16", 2), ("K2", None, 3), ("K2", None, 2)]
    if any(not counts.get(k) for k in need):
        raise RuntimeError(f"the dry run launched {show(counts)}: every one of K1 bf16 and K2 "
                           "at D=2 and D=3 must run")
    first = ranks[0]
    log(f"[entry] dryrun_multichip({n}) over NCCL: sharded step losses "
        f"{[round(x, 5) for x in first['sharded_step']['losses']]}, NeRF loss "
        f"{first['nerf']['loss']:.5f} after {first['nerf']['iter_count']} iterations, granule "
        f"losses {[round(x, 5) for x in first['granules']['losses']]}; {dry_s:.1f} s with the "
        f"ranks' start; launches over the ranks {show(counts)}, on {card}")
    log(f"[time] {time.perf_counter() - t_phase:.1f} s in the entry phase")
    return {"entry": entry_counts, "entry dryrun": counts}


def main() -> int:
    t_start = time.perf_counter()
    name, smi = phase_device()
    sys.path.insert(0, str(REPO))
    phase_build()
    config = json.loads(CONFIG.read_text())
    ngp = config["pipeline"]["instant_ngp"]
    encodings = {"pos": ngp["encoding"], "surface": ngp["surface_encoding"]["nested"][0]}
    big = json.loads((CONFIGS / "instant_ngp_occ21.json").read_text())
    rows = phase_kernels(encodings, big["pipeline"]["instant_ngp"]["encoding"])
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the kernel phase")
    counts, ctx = phase_slice(smi)
    phase_profile(ctx, smi)
    phase_card_vs_cpu(ctx)
    paths = {"flagship inference": counts, "flagship training": phase_train(ctx, smi, rows)}
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the flagship's training")
    paths.update(phase_extract(ctx, smi, rows))
    del ctx["trainer"]
    torch.cuda.empty_cache()
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the extract phase")
    paths.update(phase_configs(ctx, smi, rows))
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the other configurations")
    paths.update(phase_nerf(ctx["ds"], smi))
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the NeRF path")
    paths.update(phase_include_height(ctx["ds"], smi))
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the NeRF and height paths")
    paths.update(phase_multi_device(ctx, smi))
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the multi-device phase")
    paths.update(phase_tools(ctx, smi, rows))
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the tools phase")
    paths.update(phase_quality(ctx, smi, rows))
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the quality phase")
    paths.update(phase_collapse(smi))
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the collapse phase")
    paths.update(phase_entry(smi, rows))
    log(f"[time] {time.perf_counter() - t_start:.1f} s to the end of the entry phase")
    for row in rows:
        keys = row.pop("key")
        keys = keys if isinstance(keys, list) else [keys]
        row["launches_by_path"] = {path: sum(c[k] for k in keys) for path, c in paths.items()
                                   if sum(c[k] for k in keys)}
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
