"""The level plan of the hash-grid kernels (``ops/kernel_plan.py``) on the
CPU: which way each level of every shipped grid is taken, that the staged
blocks' slices and chunks cover rows and points once and only once within
the card's limits, and a numpy emulation of what the K2 blocks do, held to
``hash_bwd_plain``. Imports torch and the port only."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from atmonr_tpu_torch.models import hash_grid as hg
from atmonr_tpu_torch.ops import hash_bwd as hbo
from atmonr_tpu_torch.ops import hash_gather as hgo
from atmonr_tpu_torch.ops import kernel_plan as kp

CONFIG_DIR = Path(__file__).parent.parent / "configs"
# the 15 configs the port runs (the two pair-bucket ones raise)
CONFIGS = (
    "instant_ngp.json", "instant_ngp_occ21.json", "instant_ngp_tpu.json",
    "instant_ngp_tpu_fast.json", "instant_ngp_tpu_occ.json", "instant_ngp_tpu_occ13.json",
    "instant_ngp_tpu_occ13_bf16.json", "instant_ngp_tpu_occ13_clip.json",
    "instant_ngp_tpu_occ13_noclip.json", "instant_ngp_tpu_occ13_q8.json",
    "instant_ngp_tpu_occ13_q8sr.json", "instant_ngp_tpu_occ13_qh.json",
    "instant_ngp_tpu_occ13_rs.json", "instant_ngp_tpu_occ13_sp.json",
    "instant_ngp_tpu_occ14.json",
)
# (bytes of a staged row, scatter): K1 over 2-, 4- and 8-byte rows; K2
KERNELS = {"K1-2": (2, False), "K1-4": (4, False), "K1-8": (8, False), "K2": (8, True)}
POINTS = (1, 1_000, 8_192, 196_608, 1_048_576)


def _grid(name: str, which: str) -> hg.HashGridConfig:
    ngp = json.loads((CONFIG_DIR / name).read_text())["pipeline"]["instant_ngp"]
    if which == "pos":
        return hg.HashGridConfig.from_options(ngp["encoding"], 3)
    return hg.HashGridConfig.from_options(ngp["surface_encoding"]["nested"][0], 2)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("which", ["pos", "surface"])
@pytest.mark.parametrize("name", CONFIGS)
def test_plan_covers_rows_and_points_once(name, which, kernel):
    cfg = _grid(name, which)
    row_bytes, scatter = KERNELS[kernel]
    group = 1 if scatter else kp.GROUP_LEVELS  # levels of a staged block
    slices = [sum(cfg.level_sizes[lv:lv + group]) * row_bytes
              for lv in range(0, cfg.n_levels, group)]
    budget = kp.SCATTER_BUDGET if scatter else kp.SHARED_BUDGET
    assert kp.SCATTER_BUDGET * 2 == kp.SHARED_BUDGET == 232_448
    for m in POINTS:
        plan = kp.level_plan(cfg, m, row_bytes, scatter)
        assert plan is kp.level_plan(cfg, m, row_bytes, scatter)  # one object per argument set
        # each level is taken exactly one way, and a launch is staged whole or not at all
        assert len(plan.ways) == cfg.n_levels
        assert set(plan.ways) in ({"staged"}, {"direct"})
        assert plan.staged == (plan.ways[0] == "staged")
        assert plan.blocks <= 2**31 - 1
        # direct because a slice does not fit a block, or the points are too few
        if max(slices) > budget or m <= 8_192:
            assert not plan.staged
        if m == 1_048_576:
            assert plan.staged == (max(slices) <= budget)
        if plan.staged:
            # a block holds every row of its level (K1: of its group's levels) at once:
            # the slices cover each level's rows once and only once
            assert plan.shared_bytes == max(slices) <= budget
            assert plan.shared_bytes % 16 == 0
            assert all(rows % 8 == 0 and off % 8 == 0
                       for rows, off in zip(cfg.level_sizes, cfg.level_offsets))
            # the chunks cover [0, m) once and only once
            assert plan.chunk_points > 0
            assert (plan.n_chunks - 1) * plan.chunk_points < m <= plan.n_chunks * plan.chunk_points
            # one block per (level or group of 4, chunk), as many as the card has SMs
            assert plan.blocks == len(slices) * plan.n_chunks >= kp.MIN_STAGED_BLOCKS
            assert plan.threads == (kp.STAGED_THREADS if scatter else kp.GATHER_THREADS)
            step = kp.STAGED_THREADS * kp.RUN_POINTS if scatter else kp.GATHER_THREADS
            assert plan.chunk_points % step == 0
            assert "staged" in plan.describe() and str(plan.shared_bytes) in plan.describe()
        else:
            assert (plan.chunk_points, plan.n_chunks, plan.shared_bytes) == (0, 0, 0)
            assert plan.threads == kp.DIRECT_THREADS
            # one thread per (point, level); K2: per (run of points, level)
            assert plan.run_points in ((1, 2, 4, 8) if scatter else (1,))
            threads = -(-m // plan.run_points) * cfg.n_levels
            assert plan.blocks == -(-threads // kp.DIRECT_THREADS)
            # shorter runs only where longer ones would leave the card short of threads
            assert plan.run_points == (kp.RUN_POINTS if scatter else 1) or \
                -(-m // (2 * plan.run_points)) * cfg.n_levels < kp.MIN_DIRECT_THREADS
            assert "direct" in plan.describe()
        assert plan.describe().startswith("levels: ")


def test_plan_depends_on_the_grid_the_points_and_the_row_width_alone():
    """Equal arguments give the same object, whatever else the config
    names; a grid with a level that no block can hold is direct; too many
    levels raise."""
    a = hg.HashGridConfig(n_dims=3, log2_hashmap_size=13, per_level_scale=1.3819, fwd_mode="q8")
    b = hg.HashGridConfig(n_dims=3, log2_hashmap_size=13, per_level_scale=1.3819, fwd_mode="q8")
    assert kp.level_plan(a, 4096, 2, False) is kp.level_plan(b, 4096, 2, False)
    assert set(kp.level_plan(a, 196_608, 2, False).ways) == {"staged"}
    assert set(kp.level_plan(a, 196_608, 4, False).ways) == {"staged"}
    assert set(kp.level_plan(a, 196_608, 8, False).ways) == {"direct"}  # 4 x 64 KB a group
    assert set(kp.level_plan(a, 196_608, 8, True).ways) == {"staged"}
    assert set(kp.level_plan(a, 8_192, 8, True).ways) == {"direct"}  # too few points
    a14 = hg.HashGridConfig(n_dims=3, log2_hashmap_size=14, per_level_scale=1.3819)
    assert set(kp.level_plan(a14, 196_608, 2, False).ways) == {"staged"}  # 4 x 32 KB
    assert set(kp.level_plan(a14, 196_608, 8, True).ways) == {"direct"}  # one 128 KB block an SM
    big = hg.HashGridConfig(n_dims=3, log2_hashmap_size=21, per_level_scale=1.3819)
    plan = kp.level_plan(big, 1 << 20, 8, True)
    assert set(plan.ways) == {"direct"} and plan.run_points == kp.RUN_POINTS
    assert kp.level_plan(big, 0, 8, True).blocks == 0
    with pytest.raises(ValueError):
        kp.level_plan(hg.HashGridConfig(n_dims=3, n_levels=33, per_level_scale=1.1), 64, 4, False)
    with pytest.raises(ValueError):
        kp.level_plan(a, 64, 3, False)


@pytest.fixture
def small_blocks(monkeypatch):
    """Staged blocks of 16 threads (chunks of 128 points), and any number of
    them enough to stage a launch, so that a small grid on a few hundred
    points is staged in several chunks."""
    kp.level_plan.cache_clear()
    monkeypatch.setattr(kp, "MIN_STAGED_BLOCKS", 1)
    monkeypatch.setattr(kp, "STAGED_THREADS", 16)
    yield
    kp.level_plan.cache_clear()


@pytest.mark.parametrize("m,budget", [(1, 4096), (700, 4096), (3_001, 4096), (3_001, 1024)],
                         ids=["1", "700", "3001", "3001-direct"])
def test_numpy_emulation_of_the_staged_blocks_sums_every_term_once(small_blocks, monkeypatch,
                                                                   m, budget):
    """What the K2 blocks do, in numpy: a staged block zeroes its level's
    accumulators, walks its chunk of points in runs of 8, sums the corners of
    consecutive points that share a cell before it adds them, and flushes the
    non-zero rows; a direct launch's runs go straight to the table (here
    where K2's share of a block's shared memory is shrunk below the largest
    level). The
    result equals ``hash_bwd_plain`` to rtol 1e-6 (+ 1e-6 of max|dW|: float32
    summation order)."""
    monkeypatch.setattr(kp, "SCATTER_BUDGET", budget)
    cfg = hg.HashGridConfig(n_dims=3, n_levels=4, log2_hashmap_size=9, base_resolution=4,
                            per_level_scale=1.5)
    assert cfg.level_sizes == (64, 216, 512, 512)
    plan = kp.level_plan(cfg, m, hbo.ACC_BYTES, True)
    if budget >= 512 * hbo.ACC_BYTES:
        assert plan.ways == ("staged",) * 4 and plan.shared_bytes == 4096
        assert plan.chunk_points == 512 and plan.n_chunks == -(-m // 512)
    else:  # the 512-row levels do not fit a block: no level is staged
        assert plan.ways == ("direct",) * 4
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (m, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(m, 8)).astype(np.float32))
    out = np.zeros((cfg.total_params, 2), np.float64)

    def add_runs(level, lo, hi, run_points, add):
        """The runs of ``run_points`` points of [lo, hi) at ``level``:
        ``add(rows, sums)`` once per stretch of consecutive points in one
        cell."""
        idx, w = hg.level_indices(x[lo:hi], cfg, level)
        vals = w[..., None] * g[lo:hi, None, 2 * level:2 * level + 2]  # exact f32 products
        idx, vals = idx.numpy(), vals.numpy().astype(np.float64)
        base = hg._base_and_frac(x[lo:hi], cfg, level)[0].numpy()
        n_adds = 0
        for start in range(0, hi - lo, run_points):
            stop = min(start + run_points, hi - lo)
            first = start
            for i in range(start + 1, stop + 1):
                if i == stop or (base[i] != base[first]).any():
                    assert (idx[first:i] == idx[first]).all()  # one cell, the same rows
                    add(idx[first], vals[first:i].sum(axis=0))
                    n_adds += 1
                    first = i
        return n_adds

    flushed = adds = 0
    if plan.staged:
        for block in range(plan.blocks):
            level, chunk = block % cfg.n_levels, block // cfg.n_levels
            lo, hi = chunk * plan.chunk_points, min(m, (chunk + 1) * plan.chunk_points)
            acc = np.zeros((cfg.level_sizes[level], 2))
            adds += add_runs(level, lo, hi, kp.RUN_POINTS,
                             lambda rows, sums: np.add.at(acc, rows, sums))
            touched = np.flatnonzero((acc != 0).any(axis=1))
            out[cfg.level_offsets[level] + touched] += acc[touched]
            flushed += len(touched)
        assert 0 < flushed <= cfg.total_params * plan.n_chunks
    else:
        for level in range(cfg.n_levels):
            adds += add_runs(
                level, 0, m, plan.run_points,
                lambda r, sums: np.add.at(out, cfg.level_offsets[level] + r, sums))
    assert 0 < adds <= cfg.n_levels * m
    want = hbo.hash_bwd_plain(x, g, cfg).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_wrappers_ask_for_the_plan_of_their_row_width():
    """K1 plans with its table's row width, K2 with its 8-byte accumulators;
    both hand the kernels the grid's per-level arrays, row counts last."""
    assert hgo.ROW_BYTES == {"q8": 2, "bf16": 4, "f32": 8, "f8": 2}
    assert set(hgo.ROW_BYTES) == set(hg.KERNEL_MODES)
    for mode, dtype in hgo.TABLE_DTYPES.items():
        assert hgo.ROW_BYTES[mode] == 2 * torch.empty((), dtype=dtype).element_size()
    assert hbo.ACC_BYTES == 8
    cfg = _grid("instant_ngp_tpu_occ13.json", "pos")
    scale, res, offset, dense, rows = hbo.level_args(cfg)
    assert list(rows) == list(cfg.level_sizes) and list(offset) == list(cfg.level_offsets)
    assert list(res) == list(cfg.level_resolutions) and len(scale) == len(dense) == cfg.n_levels
