"""Kernels K1 (``csrc/hash_gather.cu``), K1p (``csrc/quantize.cu``: q8, f8
and bf16), K2
(``csrc/hash_bwd.cu``) and T2 (``csrc/block_fetch.cu``) against their plain
PyTorch versions, on the card,
and the paths that take no kernel
(the NeRF pipeline, the pair-bucket and 4-D position grids) there against
the CPU. These tests need CUDA and ``nvcc``; they skip where there is no
card. The file imports nothing of JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import warnings

import numpy as np
import pytest
import torch

from _torch_points import midpoint_points
from atmonr_tpu_torch import Trainer, get_dataset, get_pipeline
from atmonr_tpu_torch.models import hash_grid as hg
from atmonr_tpu_torch.ops import hash_bwd as hbo
from atmonr_tpu_torch.ops import hash_gather as hgo
from atmonr_tpu_torch.ops import kernel_plan as kp
from atmonr_tpu_torch.pipelines import instant_ngp, nerf

pytestmark = pytest.mark.cuda

OPTIONS = {
    "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 13,
    "base_resolution": 16, "per_level_scale": 1.3819, "fwd_mode": "q8",
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(n_dims, m, seed, dev, lo=0.0, hi=1.0):
    cfg = hg.HashGridConfig.from_options(OPTIONS, n_dims)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(
        rng.uniform(-1e-4, 1e-4, (cfg.total_params, 2)).astype(np.float32)
    ).to(dev)
    noise = torch.from_numpy(rng.uniform(size=(cfg.total_params, 2)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.uniform(lo, hi, (m, n_dims)).astype(np.float32)).to(dev)
    return cfg, table, noise, x


@pytest.mark.parametrize("stochastic", [False, True], ids=["round", "noise"])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 1.5)], ids=["in", "out"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_kernel_matches_plain(dev, n_dims, lo, hi, stochastic):
    """The kernel rounds each op as the plain version does: equal to 1e-6
    of the largest output."""
    cfg, table, noise, x = _inputs(n_dims, 5000, n_dims, dev, lo, hi)
    q, s = hgo.quantize_tables_q8(table, cfg, noise if stochastic else None)
    before = hgo.hash_gather.launches[("q8", n_dims)]
    got = hgo.hash_gather(q, s, x, cfg)
    torch.cuda.synchronize()
    assert hgo.hash_gather.launches[("q8", n_dims)] == before + 1
    want = hgo.hash_gather_plain(q, s, x, cfg)
    assert got.shape == (5000, 32)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 1.5)], ids=["in", "out"])
@pytest.mark.parametrize("mode", ["bf16", "f32", "f8"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_kernel_mode_matches_plain(dev, n_dims, mode, lo, hi):
    """The bf16, f32 and f8 instances: the same ops in the same order as
    the plain version over the decoded table, equal to 1e-6 of the largest
    output; only the launched instance's count moves."""
    cfg, table, _, x = _inputs(n_dims, 5000, 40 + n_dims, dev, lo, hi)
    prepared, scales = hgo.prepare_table(table, cfg, mode)
    before = dict(hgo.hash_gather.launches)
    got = hgo.hash_gather(prepared, scales, x, cfg)
    torch.cuda.synchronize()
    moved = {k for k, v in hgo.hash_gather.launches.items() if v != before[k]}
    assert moved == {(mode, n_dims)}
    want = hgo.hash_gather_plain(prepared, scales, x, cfg)
    assert got.shape == (5000, 32) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    if mode == "f32":  # the exact gather, bit for bit
        assert torch.equal(got, hg._hash_encode_exact(table, x, cfg))


def test_f8_kernel_decodes_every_code(dev):
    """The kernel's hand decode of float8_e4m3fn equals torch's cast for the
    254 codes that are not NaN. A one-level dense 2-D grid of 17 x 17
    vertices (scale 16) is read at ``x = (i + 0.5) / 16``, where ``pos`` is
    the integer ``i + 1`` exactly: weight 1 on one vertex and 0 on the other
    three, so the output is that vertex's decoded code times the scale."""
    cfg = hg.HashGridConfig(n_dims=2, n_levels=1, log2_hashmap_size=10, base_resolution=17,
                            per_level_scale=1.0, fwd_mode="f8")
    assert cfg.level_is_dense(0) and cfg.level_scales == (16.0,) and cfg.total_params == 296
    iy, ix = torch.meshgrid(torch.arange(15), torch.arange(15), indexing="ij")
    ix, iy = ix.reshape(-1), iy.reshape(-1)
    codes = torch.arange(256, dtype=torch.uint8)
    codes[(codes & 0x7F) == 0x7F] = 0
    table = torch.zeros((296, 2), dtype=torch.uint8)
    rows = (ix + 1) + (iy + 1) * 17
    table[rows, 0] = codes[:225]
    table[rows, 1] = codes[31:]  # the two features together hold every code
    table = table.view(torch.float8_e4m3fn).to(dev)
    scales = torch.full((1,), 0.5, device=dev)
    x = ((torch.stack([ix, iy], dim=-1).float() + 0.5) / 16.0).to(dev)
    got = hgo.hash_gather(table, scales, x, cfg).cpu()
    want = torch.stack([codes[:225], codes[31:]], dim=1).view(torch.float8_e4m3fn).float() * 0.5
    assert torch.equal(got, want) and float(want.abs().max()) == 224.0
    assert torch.equal(got, hgo.hash_gather_plain(table, scales, x, cfg).cpu())


def test_kernel_rejects_bad_inputs(dev):
    cfg, table, _, x = _inputs(3, 64, 1, dev)
    q, s = hgo.quantize_tables_q8(table, cfg)
    with pytest.raises(ValueError):
        hgo.hash_gather(q.to(torch.int32), s, x, cfg)
    with pytest.raises(ValueError):
        hgo.hash_gather(q, s, x.double(), cfg)
    with pytest.raises(ValueError):
        hgo.hash_gather(q.cpu(), s, x, cfg)
    with pytest.raises(ValueError):
        hgo.hash_gather(q, None, x, cfg)
    with pytest.raises(ValueError):
        hgo.hash_gather(table, s, x, cfg)


@pytest.mark.parametrize("mode", hg.KERNEL_MODES)
def test_empty_batch(dev, mode):
    cfg, table, _, _ = _inputs(2, 1, 2, dev)
    prepared, scales = hgo.prepare_table(table, cfg, mode)
    out = hgo.hash_gather(prepared, scales, torch.empty((0, 2), device=dev), cfg)
    assert out.shape == (0, 32)


def test_quantizers_match_the_cpu(dev):
    """The table preparations on the card equal the CPU's bit for bit
    (frexp / ldexp scales, the float8 and bfloat16 casts)."""
    cfg, table, noise, _ = _inputs(3, 1, 3, dev)
    table[5, 0] = 448.0 * 2.0**-20  # a level whose max / 448 is a power of two
    for mode in hg.KERNEL_MODES:
        a, sa = hgo.prepare_table(table, cfg, mode, noise if mode == "q8" else None)
        b, sb = hgo.prepare_table(table.cpu(), cfg, mode, noise.cpu() if mode == "q8" else None)
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8)), mode
        assert (sa is None and sb is None) or torch.equal(sa.cpu(), sb), mode


# K1p's grids: the flagship's two tables, a 2^14 grid and the largest q8/f8
# table the gate lets through (32 levels of at most 2^16 rows)
QUANTIZE_GRIDS = {
    "pos": (OPTIONS, 3),
    "surface": (OPTIONS, 2),
    "2^14": (dict(OPTIONS, log2_hashmap_size=14), 3),
    "gate 32 x 2^16": (dict(OPTIONS, n_levels=32, log2_hashmap_size=16), 3),
}


def _quantize_case(grid, seed, dev):
    options, n_dims = QUANTIZE_GRIDS[grid]
    cfg = hg.HashGridConfig.from_options(options, n_dims)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1e-4, 1e-4, (cfg.total_params, 2)).astype(np.float32)
    noise = rng.uniform(size=table.shape).astype(np.float32)
    return cfg, torch.from_numpy(table).to(dev), torch.from_numpy(noise).to(dev)


def _plain_quantize(table, cfg, mode, noise):
    """The plain version on the CPU."""
    table = table.cpu()
    if mode == "f8":
        return hgo.quantize_tables_f8(table, cfg)
    return hgo.quantize_tables_q8(table, cfg, None if noise is None else noise.cpu())


def _assert_quantized_equal(got, want):
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    assert torch.equal(got[0].cpu().view(torch.uint8), want[0].view(torch.uint8))
    assert torch.equal(got[1].cpu(), want[1])


# clusters of 1 block (a level in one block), 2 and the plan's 8
CLUSTERS = {"cluster 1": 1, "cluster 2": 2, "plan": kp.QUANTIZE_CLUSTER}


@pytest.mark.parametrize("cluster", CLUSTERS.values(), ids=CLUSTERS)
@pytest.mark.parametrize("mode", ["q8", "q8 noise", "f8"])
@pytest.mark.parametrize("grid", QUANTIZE_GRIDS)
def test_quantizer_kernel_equals_plain(dev, grid, mode, cluster):
    """K1p's codes and scales equal the plain version's on the CPU bit for
    bit, in clusters of 1, 2 and the plan's 8 blocks a level, and its count
    rises by exactly one a table."""
    cfg, table, noise = _quantize_case(grid, 70, dev)
    u = noise if mode == "q8 noise" else None
    before = dict(hgo.quantize_tables.launches)
    got = hgo.quantize_tables(table, cfg, mode[:2], u, cluster)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in hgo.quantize_tables.launches.items() if v != before[k]}
    assert moved == {(mode[:2], cfg.n_dims): 1}
    _assert_quantized_equal(got, _plain_quantize(table, cfg, mode[:2], u))


@pytest.mark.parametrize("mode", ["q8", "q8 noise", "f8"])
@pytest.mark.parametrize("grid", QUANTIZE_GRIDS)
def test_plain_quantizer_on_the_card_equals_the_cpu(dev, grid, mode):
    """The plain version that K1p is held to runs its divisions as true
    float32 divisions on the card too (PyTorch's CUDA division by a Python
    number multiplies by the reciprocal): equal to the CPU's bit for bit."""
    cfg, table, noise = _quantize_case(grid, 73, dev)
    u = noise if mode == "q8 noise" else None
    got = (hgo.quantize_tables_f8(table, cfg) if mode == "f8"
           else hgo.quantize_tables_q8(table, cfg, u))
    _assert_quantized_equal(got, _plain_quantize(table, cfg, mode[:2], u))


def _edge_table(cfg, dev):
    """The flagship position grid's table with four crafted levels: level 1
    all zeros (scale 1e-30 / 127); level 2 with max|t| 127 (q8 scale 1) and
    entries at exactly k + 0.5 (round half to even); level 3 with a max m
    whose q8 quotient m / (m / 127) rounds above 127, so noise lifts its
    code to 128 (clamped to 127) and -m floors to -128 (clamped to -127);
    level 4 with max 448 * 2^-20 (m / 448 a power of two: f8 scale 2^-20).
    Returns (table, noise, where level 3's m and -m are)."""
    rng = np.random.default_rng(71)
    table = rng.uniform(-1e-4, 1e-4, (cfg.total_params, 2)).astype(np.float32)
    noise = np.zeros_like(table)
    off = cfg.level_offsets
    table[off[1]:off[2]] = 0.0
    table[off[2]:off[3]] *= np.float32(1e4)
    table[off[2]:off[2] + 6, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    cands = rng.uniform(1e-4, 1e-2, 4096).astype(np.float32)
    m = next(c for c in cands if c / (c / np.float32(127)) > np.float32(127))
    table[off[3]:off[4]] *= np.float32(m / 2e-4)
    at = (off[3] + 5, off[3] + 9)
    table[at[0], 1], table[at[1], 0] = m, -m
    noise[at[0], 1] = np.nextafter(np.float32(1), np.float32(0))
    table[off[4] + 3, 1] = -np.float32(448.0 * 2.0**-20)
    return torch.from_numpy(table).to(dev), torch.from_numpy(noise).to(dev), at


@pytest.mark.parametrize("cluster", [2, kp.QUANTIZE_CLUSTER], ids=["cluster 2", "plan"])
@pytest.mark.parametrize("mode", ["q8", "q8 noise", "f8"])
def test_quantizer_kernel_edge_cases(dev, mode, cluster):
    """The crafted levels of ``_edge_table``: bit-equal to the plain version,
    with the values each edge case implies."""
    cfg = hg.HashGridConfig.from_options(OPTIONS, 3)
    table, noise, at = _edge_table(cfg, dev)
    u = noise if mode == "q8 noise" else None
    codes, scales = hgo.quantize_tables(table, cfg, mode[:2], u, cluster)
    _assert_quantized_equal((codes, scales), _plain_quantize(table, cfg, mode[:2], u))
    codes, scales, off = codes.cpu(), scales.cpu(), cfg.level_offsets
    if mode == "f8":
        assert scales[4].item() == 2.0**-20 and codes[off[4] + 3, 1].float().item() == -448.0
        return
    assert scales[1].item() == float(np.float32(np.float32(1e-30) / np.float32(127)))
    assert scales[2].item() == 1.0 and not codes[off[1]:off[2]].any()
    if u is None:
        assert codes[off[2]:off[2] + 6, 0].tolist() == [127, 0, 2, 2, 0, -2]
    assert codes[at[0], 1].item() == 127 and codes[at[1], 0].item() == -127


def test_quantizer_kernel_keeps_a_nan_in_the_scale(dev):
    """A level holding a NaN has a NaN scale, as ``torch.clamp`` keeps it in
    the plain version (``fmaxf`` would drop it), in every cluster size, with
    the NaN in rank 0's slice and in the last rank's where the level is cut;
    the other levels are equal."""
    cfg = hg.HashGridConfig.from_options(OPTIONS, 3)
    keep = torch.arange(cfg.n_levels) != 5
    for row in (2, cfg.level_sizes[5] - 2):
        table = _edge_table(cfg, dev)[0]
        table[cfg.level_offsets[5] + row, 0] = float("nan")
        for mode in ("q8", "f8"):
            want = _plain_quantize(table, cfg, mode, None)[1]
            for cluster in CLUSTERS.values():
                got = hgo.quantize_tables(table, cfg, mode, None, cluster)[1].cpu()
                if mode == "q8":
                    assert got[5].isnan() and want[5].isnan()
                assert torch.equal(got[keep], want[keep])


def test_quantizer_kernel_is_one_launch(dev):
    """A call is one launch of one kernel: the counter moves by one, and the
    profiler's trace holds exactly one kernel, the clustered quantizer, and
    no other device work beside the outputs' allocation."""
    from torch.profiler import ProfilerActivity, profile

    cfg, table, noise = _quantize_case("pos", 74, dev)
    hgo.quantize_tables(table, cfg, "q8", noise)  # built, occupancy checked
    torch.cuda.synchronize()
    before = hgo.quantize_tables.launches[("q8", 3)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hgo.quantize_tables(table, cfg, "q8", noise)
        torch.cuda.synchronize()
    assert hgo.quantize_tables.launches[("q8", 3)] == before + 1
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    assert len(names) == 1 and "quantize_kernel" in names[0], names


@pytest.mark.parametrize("mode", ["q8", "q8 noise", "f8"])
def test_quantizer_kernel_replays_in_a_cuda_graph(dev, mode):
    """A CUDA graph captures the cluster launch, and its replays, on a table
    changed in place between them, equal the plain version bit for bit."""
    cfg, table, noise = _quantize_case("gate 32 x 2^16", 75, dev)
    u = noise if mode == "q8 noise" else None
    hgo.quantize_tables(table, cfg, mode[:2], u)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        codes, scales = hgo.quantize_tables(table, cfg, mode[:2], u)
    for scale in (1.0, 3.0):
        table.mul_(scale)
        graph.replay()
        torch.cuda.synchronize()
        _assert_quantized_equal((codes, scales), _plain_quantize(table, cfg, mode[:2], u))


def test_quantizer_clusters_can_be_scheduled(dev):
    """``cudaOccupancyMaxActiveClusters`` is above 0 for every plan of the
    gate grid (32 clusters of 8 blocks of 512 threads) and the flagship's,
    in every mode, and the launch floor's empty kernel runs in that shape."""
    for grid in ("gate 32 x 2^16", "pos", "surface"):
        cfg = _quantize_case(grid, 76, dev)[0]
        for cluster in kp.QUANTIZE_CLUSTERS:
            plan = kp.quantize_plan(cfg, cluster)
            for mode, noise in (("q8", False), ("q8", True), ("f8", False)):
                assert hgo.quantize_max_active_clusters(
                    plan, mode, noise, torch.cuda.current_device()) > 0
    gate = kp.quantize_plan(_quantize_case("gate 32 x 2^16", 76, dev)[0])
    assert (gate.blocks, gate.cluster, gate.threads) == (256, 8, 512)
    hgo.quantize_launch_floor(gate, dev)
    torch.cuda.synchronize()


def test_prepare_table_takes_the_quantizer_kernel_or_raises(dev, monkeypatch):
    """On the card ``prepare_table`` in q8 and f8 is K1p and nothing else:
    with the plain version made to raise it still returns the plain
    version's numbers, a misaligned or strided table included; inputs the
    kernel does not take raise and launch nothing."""
    cfg, table, noise = _quantize_case("pos", 72, dev)
    want = {mode: _plain_quantize(table, cfg, mode, noise if mode == "q8" else None)
            for mode in ("q8", "f8")}

    def refuse(*args, **kwargs):
        raise AssertionError("the plain quantizer ran on a CUDA tensor")

    monkeypatch.setattr(hgo, "quantize_tables_q8", refuse)
    monkeypatch.setattr(hgo, "quantize_tables_f8", refuse)
    flat = torch.empty(table.numel() + 1, device=dev)
    misaligned = flat[1:].view(table.shape)
    misaligned.copy_(table)
    strided = table.t().contiguous().t()
    for mode in ("q8", "f8"):
        for t in (table, misaligned, strided):
            before = hgo.quantize_tables.launches[(mode, 3)]
            got = hgo.prepare_table(t, cfg, mode, noise)
            assert hgo.quantize_tables.launches[(mode, 3)] == before + 1
            _assert_quantized_equal(got, want[mode])
    before = dict(hgo.quantize_tables.launches)
    for args in ((table.double(), cfg, "q8"), (table, cfg, "q8", noise.cpu()),
                 (table, cfg, "q8", noise.double()), (table, cfg, "f8", noise),
                 (table[:-8], cfg, "q8"), (table, cfg, "bf16")):
        with pytest.raises(ValueError):
            hgo.quantize_tables(*args)
    assert hgo.quantize_tables.launches == before


# K1p's bf16 instance: the flagship's two tables and the published 2^21 one
BF16_GRIDS = {
    "pos": (OPTIONS, 3),
    "surface": (OPTIONS, 2),
    "2^21": (dict(OPTIONS, log2_hashmap_size=21), 3),
}


def _bf16_case(grid, seed, dev):
    """A table of entries over many binades (subnormals among them), with
    ties (halfway between two bfloat16s, rounded to even), signed zeros,
    infinities and NaNs."""
    options, n_dims = BF16_GRIDS[grid]
    cfg = hg.HashGridConfig.from_options(options, n_dims)
    rng = np.random.default_rng(seed)
    shape = (cfg.total_params, 2)
    binades = np.exp2(rng.integers(-140, 100, shape))
    table = (rng.standard_normal(shape) * binades).astype(np.float32)
    ties = (rng.integers(0, 1 << 16, shape[0], dtype=np.uint32) << 16) | 0x8000
    table[:, 1] = ties.view(np.float32)
    table[:4, 0] = [0.0, -0.0, np.inf, -np.inf]
    return cfg, torch.from_numpy(table).to(dev)


def _assert_bf16_equal(got, want):
    """Bit for bit where ``want`` is a number, NaN where it is NaN (a NaN's
    payload is outside the equality)."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])


@pytest.mark.parametrize("grid", list(BF16_GRIDS))
def test_bf16_rounding_kernel_equals_the_cast(dev, grid):
    """K1p's bf16 instance equals ``table.to(torch.bfloat16)`` on the card
    bit for bit, a misaligned and a strided table too, one launch a call;
    ``prepare_table`` in bf16 takes it once and counts one preparation;
    inputs it does not take raise and launch nothing."""
    cfg, table = _bf16_case(grid, 80, dev)
    d = cfg.n_dims
    want = table.to(torch.bfloat16)
    assert int(torch.isnan(want).sum()) > 0
    flat = torch.empty(table.numel() + 1, device=dev)
    misaligned = flat[1:].view(table.shape)
    misaligned.copy_(table)
    strided = table.t().contiguous().t()
    for t in (table, misaligned, strided):
        before = hgo.round_table_bf16.launches[d]
        got = hgo.round_table_bf16(t, cfg)
        torch.cuda.synchronize()
        assert hgo.round_table_bf16.launches[d] == before + 1
        _assert_bf16_equal(got, want)
    def counts():
        return hgo.round_table_bf16.launches[d], hgo.prepare_table.calls[("bf16", d)]

    before = counts()
    got, scales = hgo.prepare_table(table, cfg, "bf16")
    assert scales is None and counts() == (before[0] + 1, before[1] + 1)
    _assert_bf16_equal(got, want)
    before = dict(hgo.round_table_bf16.launches)
    for bad in (table.double(), table[:-8], table.half()):
        with pytest.raises(ValueError):
            hgo.round_table_bf16(bad, cfg)
    assert hgo.round_table_bf16.launches == before


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 1.5), (0.4, 0.41)], ids=["in", "out", "clustered"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_bwd_kernel_matches_plain(dev, n_dims, lo, hi):
    """K2's atomics add in an order that changes from run to run, so it is
    not bit-equal to the plain version: 1e-5 of max|dW| (float32 summation
    error; points that cluster put thousands of terms into one row)."""
    cfg, _, _, x = _inputs(n_dims, 5000, 10 + n_dims, dev, lo, hi)
    rng = np.random.default_rng(20)
    g = torch.from_numpy(rng.normal(size=(5000, 32)).astype(np.float32)).to(dev)
    before = hbo.hash_bwd.launches[n_dims]
    got = hbo.hash_bwd(x, g, cfg)
    torch.cuda.synchronize()
    assert hbo.hash_bwd.launches[n_dims] == before + 1
    want = hbo.hash_bwd_plain(x, g, cfg)
    assert got.shape == (cfg.total_params, 2) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _plan_case(log2, m, row_bytes, scatter, points, seed, dev):
    """A 16-level 3-D grid of 2^log2 entries and ``m`` points for the level
    plan's ways. ``m`` is 1, 257 (too few points to stage a level; K2 in
    runs of 1), 40,000 (K2 directly in runs of 2), or ``"chunk"``: the
    fewest points from 98,305 up with levels in shared
    memory and one point more than a whole number of the plan's chunks, so
    that the last staged block of each level has one point (150,001 where the
    plan stages nothing at any size). Points: in [0, 1), outside it too, or
    all in one cell of the finest level."""
    cfg = hg.HashGridConfig.from_options(dict(OPTIONS, log2_hashmap_size=log2), 3)
    if m == "chunk":
        def last_block_has_one_point(n):
            plan = kp.level_plan(cfg, n, row_bytes, scatter)
            return plan.staged and plan.n_chunks >= 2 and (n - 1) % plan.chunk_points == 0

        m = next((n for n in range(98_305, 1_200_000, 4096) if last_block_has_one_point(n)),
                 150_001)
    rng = np.random.default_rng(seed)
    if points == "cell":
        x = 0.37 + 0.9 / cfg.level_scales[-1] * rng.uniform(size=(m, 3))
    else:
        x = rng.uniform(*((0.0, 1.0) if points == "in" else (-0.5, 1.5)), (m, 3))
    return cfg, torch.from_numpy(x.astype(np.float32)).to(dev)


# the grids of the next two tests: 2^13 (staged in every table type but
# f32), 2^14 (the 2-byte tables staged), 2^15, 2^17 and the 2^21 config's
# grid (direct)
PLAN_GRIDS = [13, 14, 15, 17, 21]


@pytest.mark.parametrize("points", ["in", "out", "cell"])
@pytest.mark.parametrize("m", [1, 257, 40_000, "chunk"])
@pytest.mark.parametrize("log2", PLAN_GRIDS)
def test_bwd_kernel_matches_plain_every_way(dev, log2, m, points):
    """K2 where the plan stages the levels and where it takes them directly,
    in runs of 1 to 8 points: 1e-5 of max|dW| on spread points, 1e-4
    with every point in one cell (a row sums a hundred thousand terms, run by
    run, block by block and then atomically, in an order that is not the
    plain version's)."""
    cfg, x = _plan_case(log2, m, hbo.ACC_BYTES, True, points, 50 + log2, dev)
    g = torch.from_numpy(
        np.random.default_rng(51).normal(size=(x.shape[0], 32)).astype(np.float32)).to(dev)
    got = hbo.hash_bwd(x, g, cfg)
    torch.cuda.synchronize()
    want = hbo.hash_bwd_plain(x, g, cfg)
    tol = 1e-4 if points == "cell" else 1e-5
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("points", ["in", "out", "cell"])
@pytest.mark.parametrize("m", [1, 257, "chunk"])
@pytest.mark.parametrize("mode", hg.KERNEL_MODES)
@pytest.mark.parametrize("log2", PLAN_GRIDS)
def test_kernel_equals_plain_every_way(dev, log2, mode, m, points):
    """K1 in each table type where the plan stages the groups of levels and
    where it takes the levels directly: equal to the plain version bit for
    bit."""
    cfg, x = _plan_case(log2, m, hgo.ROW_BYTES[mode], False, points, 60 + log2, dev)
    table = torch.from_numpy(np.random.default_rng(61).uniform(
        -1e-4, 1e-4, (cfg.total_params, 2)).astype(np.float32)).to(dev)
    prepared, scales = hgo.prepare_table(table, cfg, mode)
    got = hgo.hash_gather(prepared, scales, x, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, hgo.hash_gather_plain(prepared, scales, x, cfg))


def test_plan_grids_take_levels_every_way(dev):
    """The grids of the two tests above do put the levels in each of the two
    ways, in every table type."""
    def ways(log2, row_bytes, scatter, m="chunk"):
        cfg, x = _plan_case(log2, m, row_bytes, scatter, "in", 0, dev)
        return set(kp.level_plan(cfg, x.shape[0], row_bytes, scatter).ways)

    assert ways(13, 8, True) == {"staged"} == ways(13, 4, False) == ways(13, 2, False)
    assert ways(14, 2, False) == {"staged"}
    assert ways(13, 8, False) == {"direct"} == ways(14, 4, False) == ways(14, 8, True)
    for log2 in (15, 17, 21):
        assert ways(log2, 8, True) == {"direct"} == ways(log2, 2, False)
    assert ways(13, 8, True, 257) == {"direct"} == ways(13, 2, False, 1)


@pytest.mark.parametrize("mode", hg.KERNEL_MODES)
@pytest.mark.parametrize("n_dims", [2, 3])
def test_q8_autograd_runs_both_kernels(dev, n_dims, mode):
    """The table gradient of every kernel mode's encode on the card is K2,
    whatever the rounding noise, and agrees with the plain version on the
    CPU."""
    cfg, table, noise, x = _inputs(n_dims, 3000, 30 + n_dims, dev)
    cfg = hg.HashGridConfig.from_options(dict(OPTIONS, fwd_mode=mode), n_dims)
    table.requires_grad_()
    g = torch.from_numpy(np.random.default_rng(21).normal(size=(3000, 32)).astype(np.float32)).to(dev)
    before = (hgo.hash_gather.launches[(mode, n_dims)], hbo.hash_bwd.launches[n_dims],
              dict(hgo.quantize_tables.launches))
    (got,) = torch.autograd.grad(hg.hash_encode(table, x, cfg, noise), table, g)
    torch.cuda.synchronize()
    assert (hgo.hash_gather.launches[(mode, n_dims)], hbo.hash_bwd.launches[n_dims]) == (
        before[0] + 1, before[1] + 1)
    # the q8 and f8 encodes prepare their table with K1p, once
    assert {k: v - before[2][k] for k, v in hgo.quantize_tables.launches.items()
            if v != before[2][k]} == ({(mode, n_dims): 1} if mode in ("q8", "f8") else {})
    want = hbo.hash_bwd_plain(x.cpu(), g.cpu(), cfg)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_bwd_kernel_rejects_bad_inputs(dev):
    cfg, _, _, x = _inputs(3, 64, 1, dev)
    g = torch.zeros((64, 32), device=dev)
    for bad_x, bad_g in ((x.double(), g), (x, g.half()), (x, g[:, :30]), (x.cpu(), g), (x[:, :2], g)):
        with pytest.raises(ValueError):
            hbo.hash_bwd(bad_x, bad_g, cfg)
    assert float(hbo.hash_bwd(x[:0], g[:0], cfg).abs().sum()) == 0.0
    out = hbo.hash_bwd(x, g.t().contiguous().t(), cfg)  # a strided cotangent is copied
    assert float(out.abs().sum()) == 0.0


def _small_trainer(root, dev, mode="q8", encoding=None, **pipeline_over):
    grid = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
            "log2_hashmap_size": 9, "per_level_scale": 1.5, "fwd_mode": mode}
    sh = {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2}
    net = {"n_neurons": 16, "n_hidden_layers": 1}
    pipeline = {
        "type": "InstantNGP", "include_height": False, "point_preprocessor": "horizontal",
        "num_bands": 4, "multi_band_extinction": False, "alt_compress_factor": 8,
        "loss": "mse_plus_hdr", "num_samples_per_ray": 16,
        "instant_ngp": {
            "encoding": dict(grid, base_resolution=4, stochastic_rounding=True, **(encoding or {})),
            "network": net, "rgb_network": net, "surface_network": net,
            "dir_encoding": {"otype": "Composite", "nested": [sh, {"otype": "Identity"}]},
            "surface_encoding": {"otype": "Composite", "nested": [
                dict(grid, n_dims_to_encode=2, base_resolution=16), sh]},
        },
        "occupancy": {"resolution": [8, 8, 4], "n_probe": 8, "n_fine": 6, "update_every": 2},
    }
    pipeline.update(pipeline_over)
    trainer = {
        "batch_size": 250, "num_iters": 8, "print_frequency": 2,
        "optimizer": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1e-15, "weight_decay": 0.01,
                      "clip_global_norm": 1.0},
        "scheduler": {"type": "fixed", "gamma": 0.33, "decay_start": 4, "decay_interval": 2},
    }
    dataset = {"type": "HARP2", "max_abs_view_angle": 45.0, "ray_origin_height": 20000,
               "bands_to_keep": [0, 1, 2, 3], "rgb_mode": "nadir"}
    ds = get_dataset(dataset, "synthetic:16x8x2", device=dev)
    return Trainer(trainer, ds, get_pipeline(pipeline, ds, device=dev), "card", root, device=dev)


def test_trainer_trains_and_resumes_on_the_card(dev, tmp_path):
    """A small Trainer on the card: each step launches K1 and K2 once per
    grid, the loss falls, and a resumed run keeps AdamW's step counts on the
    host (on the card every step would wait for them) and carries on."""
    first = _small_trainer(tmp_path, dev)
    before = ({d: hgo.hash_gather.launches[("q8", d)] for d in (2, 3)}, dict(hbo.hash_bwd.launches))
    losses = []
    for it in first.iterate(tmp_path / "out"):
        losses.append(first.last_loss)
        if it == 4:
            first._preempted = True
    assert first.iter_count == 4
    assert hbo.hash_bwd.launches == {d: before[1][d] + 4 for d in (2, 3)}
    assert {d: hgo.hash_gather.launches[("q8", d)] for d in (2, 3)} == {
        2: before[0][2] + 4, 3: before[0][3] + 4 + 2}
    losses = torch.stack(losses).cpu()
    assert bool(torch.isfinite(losses).all()) and float(losses[-1]) < float(losses[0])
    second = _small_trainer(tmp_path, dev)
    second.load(tmp_path / "out")
    assert second.iter_count == 4 and second.optimizer.count == 4
    state = second.optimizer.adamw.state
    assert state and all(v["step"].is_cpu and v["exp_avg"].is_cuda for v in state.values())
    for name, p in second.pipeline.named_parameters():
        assert torch.equal(p, dict(first.pipeline.named_parameters())[name]), name
    second.train(tmp_path / "out")
    assert second.iter_count == 8 and second.epoch_idx == 2


def _launches():
    return dict(hgo.hash_gather.launches), dict(hbo.hash_bwd.launches)


def _moved(before):
    after = _launches()
    return ({k: v - before[0][k] for k, v in after[0].items() if v != before[0][k]},
            {k: v - before[1][k] for k, v in after[1].items() if v != before[1][k]})


def test_kernels_refuse_a_pair_bucket_grid_on_the_card(dev):
    """K1 and K2 index per cell: on a ``hashed_tile`` grid they raise for
    CUDA tensors as for CPU ones, and launch nothing."""
    cfg = hg.HashGridConfig.from_options(dict(OPTIONS, fwd_mode="bf16", hashed_tile="on"), 3)
    x = torch.rand((64, 3), device=dev)
    before = _launches()
    with pytest.raises(ValueError, match="hashed_tile"):
        hgo.hash_gather(torch.zeros((cfg.total_params, 2), device=dev).bfloat16(), None, x, cfg)
    with pytest.raises(ValueError, match="hashed_tile"):
        hbo.hash_bwd(x, torch.zeros((64, 32), device=dev), cfg)
    assert _moved(before) == ({}, {})


@pytest.mark.parametrize("variant", ["pair_bucket", "include_height"])
def test_kernel_less_position_grid_on_the_card(dev, tmp_path, monkeypatch, variant):
    """A pair-bucket position grid (``hashed_tile: "on"``) and a 4-D one
    (``include_height``, uniform sampler, no preprocessor) take the exact
    gather over the bf16 table on the card: a forward's color, surface
    color and depths equal to the CPU's (float32 MLPs, the card's
    preprocessor and heights) to rtol 1e-4 plus 1e-6 of the largest value
    on all but one of 250 rays; two train steps launch K1 bf16 and K2 for
    the surface grid only, and the loss stays finite."""
    if variant == "pair_bucket":
        trainer = _small_trainer(tmp_path, dev, "auto", {"hashed_tile": "on"})
    else:
        trainer = _small_trainer(tmp_path, dev, "auto", include_height=True,
                                 point_preprocessor=None, occupancy=None)
    pipe, ds = trainer.pipeline, trainer.dataset
    assert hg.resolve_fwd_mode(pipe.pos_cfg) == "xla_bf16"
    cpu = get_pipeline(pipe.config, ds, device="cpu")
    cpu.load_state_dict(pipe.state_dict())
    pipe.compute_dtype = cpu.compute_dtype = torch.float32
    batch = {k: v[:250] for k, v in ds.rays(dev).items()}
    # the float32 preprocessor and height solve differ by ulps between the
    # devices (~2e-4 of the normalized altitude): the CPU takes the card's
    if pipe.point_preprocessor:
        cpu.point_preprocessor = lambda pts: pipe.point_preprocessor(pts.to(dev)).cpu()
    heights = instant_ngp.append_heights
    monkeypatch.setattr(instant_ngp, "append_heights",
                        lambda pts, *a: heights(pts.to(dev), *a).to(pts.device))
    with torch.no_grad():
        a = pipe(batch)
        b = cpu({k: v.cpu() for k, v in batch.items()})
    bad = torch.zeros(250, dtype=torch.bool)
    for k in ("color_map_fine", "color_surf", "z_vals_fine"):
        err = (a[k].cpu() - b[k]).abs() > 1e-4 * b[k].abs() + 1e-6 * b[k].abs().max()
        bad |= err.reshape(250, -1).any(dim=1)
    assert int(bad.sum()) <= 1, int(bad.sum())
    pipe.compute_dtype = torch.bfloat16
    before = _launches()
    losses = [trainer.step(torch.arange(250, device=dev)) for _ in range(2)]
    assert _moved(before) == ({("bf16", 2): 2}, {2: 2})
    assert all(bool(torch.isfinite(x)) for x in losses)


def test_pair_bucket_step_opens_the_exact_spans_on_the_card(dev, tmp_path):
    """A small pair-bucket Trainer's two steps and its refresh on the card,
    spans recorded: the position grid's exact gather opens
    ``hash_encode.fwd`` (its points) with ``hash_encode.prepare`` (its
    rows) inside, as the surface grid's K1p + K1 do, and its backward
    ``hash_encode.bwd`` (its points) on autograd's device thread under
    ``trainer.backward``, as K2's; ``hash_encode_exact.calls[("xla_bf16",
    3)]`` counts the two steps' encodes and the refresh's."""
    from atmonr_tpu_torch.utils import spans

    trainer = _small_trainer(tmp_path, dev, "auto", {"hashed_tile": "on"})
    pipe = trainer.pipeline
    rays, fine, cells = 250, 6, 8 * 8 * 4
    before = dict(hg.hash_encode_exact.calls)
    with spans.recording() as records:
        losses = [trainer.step(torch.arange(rays, device=dev)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x)) for x in losses)
    moved = {k: v - before[k] for k, v in hg.hash_encode_exact.calls.items() if v != before[k]}
    assert moved == {("xla_bf16", 3): 3}
    of = {r.id: r for r in records}
    step_thread = {r.thread for r in records if r.name == "trainer.step"}
    fwd = sorted(r.count for r in records if r.name == "hash_encode.fwd")
    assert fwd == sorted([rays * fine, rays] * 2 + [cells])
    prep = sorted(r.count for r in records if r.name == "hash_encode.prepare")
    surf_rows = next(iter(pipe.surf_enc.values())).shape[0]
    assert prep == sorted([pipe.pos_cfg.total_params] * 3 + [surf_rows] * 2)
    assert all(of[r.parent].name == "hash_encode.fwd" for r in records
               if r.name == "hash_encode.prepare")
    bwd = [r for r in records if r.name == "hash_encode.bwd"]
    assert sorted(r.count for r in bwd) == sorted([rays * fine, rays] * 2)
    assert all(of[r.parent].name == "trainer.backward" and r.thread not in step_thread
               for r in bwd)


def _encode_launches() -> dict:
    """K1's and K1p's launches, the table preparations and the exact
    gathers."""
    return {**{("K1",) + k: v for k, v in hgo.hash_gather.launches.items()},
            **{("K1p",) + k: v for k, v in hgo.quantize_tables.launches.items()},
            **{("K1p", "bf16", d): v for d, v in hgo.round_table_bf16.launches.items()},
            **{("prepare",) + k: v for k, v in hgo.prepare_table.calls.items()},
            **{("exact",) + k: v for k, v in hg.hash_encode_exact.calls.items()}}


_GRAPHED_EXTRACTIONS = {  # kind: (config, include_height)
    "q8": ("instant_ngp_tpu_occ13.json", False),  # the flagship: K1p and K1 q8
    "bf16_2^21": ("instant_ngp_occ21.json", False),  # the published table: K1p and K1 bf16
    "nerf": ("nerf.json", False),  # GEMMs alone
    "pb": ("instant_ngp_pb.json", False),  # pair-bucket hash: the exact gather
    "ngp_height": ("instant_ngp_tpu.json", True),  # a 4-D position grid, no kernel
    "nerf_height": ("nerf.json", True),
}


@pytest.mark.parametrize("kind", list(_GRAPHED_EXTRACTIONS))
def test_extraction_replays_a_cuda_graph(dev, kind):
    """``run_extraction`` over two full 32,768-point batches and a tail of
    5,000, for the flagship q8 pipeline, the published 2^21 bf16 tables,
    the NeRF, a pair-bucket grid and both pipelines with
    ``include_height``: each call stages its three batches through the
    pinned ring, warms up on the first full batch, captures once, replays
    the second and drops the graph; after
    ``load_params`` (in place) the next call reads the new values; one full
    batch and a tail capture nothing. The exact gathers of the pair-bucket
    and 4-D grids count one a batch in ``hash_encode_exact.calls``, replays
    included. The float64 points sit at float32
    midpoints once normalized, where a product with the reciprocal of the
    scale rounds other ways: the card's ``normalize`` equals the host's
    normalisation bit for bit, and each sigma equals the eager query's
    (``pipeline.extract`` of each host-normalized float32 batch over
    ``scale``) bit for bit. K1, K1p and the table preparations advance by
    the eager query's: one of each a batch, replays included. The device
    peak of a call, over what was allocated before it, grows by sigma's
    bytes alone when two full batches are added: no (N, 3) array of the
    points is on the card."""
    from atmonr_tpu_torch import load_config, run_extraction
    from atmonr_tpu_torch.extract.runner import normalize

    name, height = _GRAPHED_EXTRACTIONS[kind]
    config = load_config(f"configs/{name}")
    if height:
        config["pipeline"].update(include_height=True, point_preprocessor=None)
        if kind == "nerf_height":
            config["pipeline"]["encoder"]["L_x"] = config["pipeline"]["encoder"]["L_x"] + [10]
    ds = get_dataset(config["dataset"], "synthetic:16x8x2", device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a varying L_x without a preprocessor
        pipe = get_pipeline(config["pipeline"], ds, device=dev,
                            generator=torch.Generator().manual_seed(3))
    if isinstance(pipe, instant_ngp.InstantNGPPipeline):
        assert pipe.pos_cfg.n_dims == (4 if height else 3)
        assert (pipe.pos_cfg.hashed_tile == "on") == (kind == "pb")
        with torch.no_grad():  # a field, not zeros
            pipe.pos_table.uniform_(-0.5, 0.5)
            pipe.pos_mlp.layers[-1].weight.abs_()
    b, full = 32768, 2
    n = full * b + 5000
    offset = np.asarray(pipe.offset, np.float64)
    xyz = midpoint_points(2 * n, 4, offset, pipe.scale, reach=0.9)
    host = ((xyz - offset[None]) / pipe.scale).astype(np.float32)
    card = normalize(torch.from_numpy(xyz).to(dev), torch.from_numpy(offset).to(dev),
                     torch.tensor(float(pipe.scale), dtype=torch.float64, device=dev))
    np.testing.assert_array_equal(card.cpu().numpy(), host)
    assert (((xyz - offset[None]) * (1.0 / pipe.scale)).astype(np.float32) != host).any()
    pts = torch.from_numpy(host[:n]).to(dev)

    def moved(before):
        return {k: v - before[k] for k, v in _encode_launches().items() if v != before[k]}

    def eager():
        before = _encode_launches()
        with torch.no_grad():
            out = torch.cat([pipe.extract(pts[i:i + b]) / pipe.scale for i in range(0, n, b)])
        return out.cpu().numpy(), moved(before)

    def counters():
        return (run_extraction.graph_batches, run_extraction.eager_batches,
                run_extraction.captures, run_extraction.staged_batches)

    def graphed(points):
        before, launches = counters(), _encode_launches()
        sigma = run_extraction(pipe, points, batch_size=b)
        return sigma, tuple(a - c for a, c in zip(counters(), before)), moved(launches)

    def peak_of_a_call(points) -> int:
        """The call's device peak over what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        run_extraction(pipe, points, batch_size=b)
        return torch.cuda.max_memory_allocated() - resident

    want, want_launches = eager()
    assert want.shape[0] == n and (want > 0).mean() > 0.1
    mode = {"q8": "q8", "bf16_2^21": "bf16"}.get(kind)
    exact = {"pb": 3, "ngp_height": 4}.get(kind)  # the exact gather's D
    assert want_launches == ({} if mode is None else {
        (k, mode, 3): full + 1 for k in ("K1", "K1p", "prepare")}) | (
        {} if exact is None else {("exact", "xla_bf16", exact): full + 1})
    for _ in range(2):  # each call captures on its first full batch and replays the rest
        got, got_counts, got_launches = graphed(xyz[:n])
        assert got_counts == (full - 1, 2, 1, 3) and got_launches == want_launches
        np.testing.assert_array_equal(got, want)
    got, got_counts, _ = graphed(xyz[: b + 5000])  # one full batch: nothing to replay
    assert got_counts == (0, 2, 0, 2)
    np.testing.assert_array_equal(got, want[: b + 5000])
    # two full batches more (the same tail): the peak grows by their sigma,
    # not by the 12 bytes a point a float32 copy of the points would add
    grown = np.concatenate([xyz[: 2 * b], xyz[:n]])
    sigma_bytes = 2 * b * want.shape[1] * 4
    assert peak_of_a_call(grown) - peak_of_a_call(xyz[:n]) < sigma_bytes + 2 * b * 12 // 4
    pipe.load_params({k: v.flip(0).clone() for k, v in pipe.named_parameters()})
    fresh, _ = eager()
    assert not np.array_equal(fresh, want)
    got, got_counts, _ = graphed(xyz[:n])
    assert got_counts == (full - 1, 2, 1, 3)
    np.testing.assert_array_equal(got, fresh)


def test_nerf_on_the_card(dev, tmp_path, monkeypatch):
    """A small ``configs/nerf.json`` (8 + 16 samples, 32 wide) on the card:
    no K1 or K2 launch; a deterministic render equal to the CPU's (one
    preprocessor) to rtol 1e-4 plus 1e-6 of each output's largest value on
    all but 1% of 250 rays, as ``chip_smoke.py`` holds it: the coarse pass
    and the fine depths independently, the fine pass at the
    card's fine samples (they invert the CDF of coarse weights whose last
    bits the two devices' GEMMs round differently, and an encoding at 2^13
    pi turns that into another color); four train steps with finite
    losses, a checkpoint and ``extract``."""
    from atmonr_tpu_torch import load_config

    config = load_config("configs/nerf.json")
    config["pipeline"].update(sampler={"N_c": 8, "N_f": 16}, mlp_hidden_dim=32)
    tcfg = dict(config["trainer"], batch_size=250, num_iters=4, print_frequency=2)
    ds = get_dataset(config["dataset"], "synthetic:16x8x2", device=dev)
    pipe = get_pipeline(config["pipeline"], ds, device=dev)
    cpu = get_pipeline(config["pipeline"], ds, device="cpu")
    cpu.load_state_dict(pipe.state_dict())
    cpu.point_preprocessor = lambda pts: pipe.point_preprocessor(pts.to(dev)).cpu()
    batch = {k: v[:250] for k, v in ds.rays(dev).items()}
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    before = _launches()
    card_samples = []

    def record(*args, **kwargs):
        card_samples.append(sample_pdf(*args, **kwargs))
        return card_samples[-1]

    sample_pdf = nerf.sample_pdf
    with torch.no_grad():
        monkeypatch.setattr(nerf, "sample_pdf", record)
        a = pipe(batch)
        monkeypatch.setattr(nerf, "sample_pdf", sample_pdf)
        b = cpu(batch_cpu)
        monkeypatch.setattr(nerf, "sample_pdf", lambda *_a, **_k: tuple(
            t.cpu() for t in card_samples[0]))
        shared = cpu(batch_cpu)
        monkeypatch.setattr(nerf, "sample_pdf", sample_pdf)

    def bad_rays(got, want):
        err = (got.cpu() - want).abs() > 1e-4 * want.abs() + 1e-6 * want.abs().max()
        return int(err.reshape(250, -1).any(dim=1).sum())

    for k in ("color_map_coarse", "weights_coarse", "sigma_coarse", "z_vals_fine"):
        assert bad_rays(a[k], b[k]) <= 2, k
    for k in ("color_map_fine", "weights_fine", "sigma_fine"):
        assert bad_rays(a[k], shared[k]) <= 2, k
    trainer = Trainer(tcfg, ds, pipe, "nerf", tmp_path, device=dev)
    trainer.train(tmp_path / "out")
    assert trainer.iter_count == 4 and bool(torch.isfinite(trainer.last_loss))
    sigma = pipe.extract(torch.rand((1000, 3), device=dev) * 2 - 1)
    assert sigma.shape == (1000, 4) and sigma.is_cuda and float(sigma.min()) >= 0
    assert _moved(before) == ({}, {})


def test_data_sharded_step_at_one_rank_over_nccl(dev, tmp_path):
    """``Trainer.shard`` on a mesh of one rank over NCCL (a world of one
    through a ``FileStore``): three steps on the same rays and draws as the
    unsharded Trainer of the same seed give the same losses (rtol 1e-5) and
    tables within a relative L2 of 1e-2 (K2's float atomics reorder sums,
    and AdamW's first updates are lr * sign(g)), with the same K1 and K2
    launches as the unsharded step (the refresh of step 2 in both)."""
    import torch.distributed as dist

    from atmonr_tpu_torch.parallel.mesh import make_mesh_from_spec

    plain = _small_trainer(tmp_path / "plain", dev)
    sharded = _small_trainer(tmp_path / "mesh", dev)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        sharded.shard(make_mesh_from_spec("data=1"))
        idx = torch.arange(250, device=dev)
        moved = []
        for _ in range(3):
            draws = plain.pipeline.make_draws(250, plain.generators["draws"])
            before = _launches()
            a = plain.step(idx, draws)
            moved.append(_moved(before))
            before = _launches()
            b = sharded.step(idx, draws)
            moved.append(_moved(before))
            torch.testing.assert_close(b, a, rtol=1e-5, atol=0)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert moved[0::2] == moved[1::2] and moved[0][1]
    for name, p in plain.pipeline.state_dict().items():
        q = sharded.pipeline.state_dict()[name]
        rel = float(torch.linalg.vector_norm(q - p) / torch.linalg.vector_norm(p))
        assert rel <= 1e-2, (name, rel)


def _card_mesh_config() -> dict:
    """``_small_trainer``'s q8 config with 8 fine samples (they split over 2
    and 4 sample ranks)."""
    grid = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
            "log2_hashmap_size": 9, "per_level_scale": 1.5, "fwd_mode": "q8"}
    sh = {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2}
    net = {"n_neurons": 16, "n_hidden_layers": 1}
    return {
        "dataset": {"type": "HARP2", "max_abs_view_angle": 45.0, "ray_origin_height": 20000,
                    "bands_to_keep": [0, 1, 2, 3], "rgb_mode": "nadir"},
        "pipeline": {
            "type": "InstantNGP", "include_height": False, "point_preprocessor": "horizontal",
            "num_bands": 4, "multi_band_extinction": False, "alt_compress_factor": 8,
            "loss": "mse_plus_hdr", "num_samples_per_ray": 16,
            "instant_ngp": {
                "encoding": dict(grid, base_resolution=4, stochastic_rounding=True),
                "network": net, "rgb_network": net, "surface_network": net,
                "dir_encoding": {"otype": "Composite", "nested": [sh, {"otype": "Identity"}]},
                "surface_encoding": {"otype": "Composite", "nested": [
                    dict(grid, n_dims_to_encode=2, base_resolution=16), sh]},
            },
            "occupancy": {"resolution": [8, 8, 4], "n_probe": 8, "n_fine": 8,
                          "update_every": 2},
        },
        "trainer": {
            "batch_size": 512, "num_iters": 8, "print_frequency": 2,
            "optimizer": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1e-15,
                          "weight_decay": 0.01, "clip_global_norm": 1.0},
            "scheduler": {"type": "fixed", "gamma": 0.33, "decay_start": 4,
                          "decay_interval": 2},
        },
    }


def test_meshes_across_cards_over_nccl(dev, tmp_path):
    """On every card of the machine (two or more), one NCCL rank each: the
    sample-sharded forward on mesh 1 x N and (N / 2) x 2 with K1 and K2,
    whose gradients after ``reduce_gradients`` (NCCL's reduce-scatter in
    the backward of the masked prefix) lie within 1e-3 relative L2 of the
    unsharded step's on the same rays and the loss within rtol 1e-5; then a
    ``Trainer`` on mesh data=N: 4 steps leave every card's parameters equal
    bit for bit. The CPU tests hold the same paths over gloo."""
    import _torch_ranks as ranks

    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        pytest.skip(f"needs an even number of cards, two or more ({n} here)")
    from atmonr_tpu_torch import _build

    _build.build_all(("hash_gather", "hash_bwd"))  # once, before the ranks load them
    out = ranks.spawn(n, tmp_path, ranks.card_mesh_ranks, _card_mesh_config(), str(tmp_path),
                      backend="nccl")
    for r in out:
        assert r["trained_equal"]
        for shape in ((1, n), (n // 2, 2)):
            got = r[shape]
            assert abs(got["loss"] - r["ref_loss"]) <= 1e-5 * abs(r["ref_loss"]), (shape, got)
            assert max(got["rel_l2"].values()) < 1e-3, (shape, got["rel_l2"])


# -- kernel T2, the block fetch ------------------------------------------------------------


def _fetch_inputs(dev, tile_rows, n_desc, rpd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tiles = torch.randn((tile_rows, 128), generator=gen, device=dev)
    idx = torch.randint(0, tile_rows - rpd, (n_desc,), generator=gen, device=dev,
                        dtype=torch.int32)
    return tiles, idx


@pytest.mark.parametrize("tile_rows,n_desc", [(300, 512), (330_339, 4096), (300, 256)])
@pytest.mark.parametrize("rpd", [1, 4, 32])
def test_block_fetch_equals_plain(dev, rpd, tile_rows, n_desc):
    """T2 copies the rows bit for bit (``torch.equal``), inside the L2 and
    beyond it; one launch a call."""
    from atmonr_tpu_torch.ops import block_fetch as bfo

    tiles, idx = _fetch_inputs(dev, tile_rows, n_desc, rpd, rpd)
    before = bfo.block_fetch.launches[rpd]
    got = bfo.block_fetch(tiles, idx, rpd)
    torch.cuda.synchronize()
    assert bfo.block_fetch.launches[rpd] == before + 1
    assert got.shape == (n_desc * rpd, 128)
    assert torch.equal(got, bfo.block_fetch_plain(tiles, idx, rpd))


@pytest.mark.parametrize("n_desc", [1, 5, 7])
def test_block_fetch_kernel_copies_a_tail_of_rows(dev, n_desc):
    """The kernel at a row count that is no multiple of a warp's 4 rows in
    flight (below the wrapper's 256 runs, so launched directly)."""
    from atmonr_tpu_torch.ops import block_fetch as bfo

    tiles, idx = _fetch_inputs(dev, 300, n_desc, 1, n_desc)
    got = torch.full((n_desc, 128), float("nan"), device=dev)
    err = bfo._kernel()(tiles.data_ptr(), idx.data_ptr(), got.data_ptr(), 300, n_desc, 1,
                        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(got, bfo.block_fetch_plain(tiles, idx, 1))


def test_block_fetch_reads_no_row_outside_the_table(dev):
    """A run that would leave the table is not read: its rows come out NaN,
    every other run as the plain version's."""
    from atmonr_tpu_torch.ops import block_fetch as bfo

    tiles, idx = _fetch_inputs(dev, 300, 256, 4, 3)
    idx[7], idx[100] = -1, 297
    got = bfo.block_fetch(tiles, idx, 4)
    torch.cuda.synchronize()
    bad = torch.zeros(256, dtype=torch.bool, device=dev)
    bad[[7, 100]] = True
    runs = got.reshape(256, 4, 128)
    assert bool(torch.isnan(runs[bad]).all()) and not bool(torch.isnan(runs[~bad]).any())
    ok = idx.clone()
    ok[bad] = 0
    assert torch.equal(runs[~bad], bfo.block_fetch_plain(tiles, ok, 4).reshape(256, 4, 128)[~bad])


def test_block_fetch_rejects_bad_inputs(dev):
    from atmonr_tpu_torch.ops import block_fetch as bfo

    tiles, idx = _fetch_inputs(dev, 300, 256, 1, 4)
    shifted = tiles.reshape(-1)[1:1 + 299 * 128].view(299, 128)
    with pytest.raises(ValueError, match="aligned"):
        bfo.block_fetch(shifted, idx, 1)
    with pytest.raises(ValueError, match="one device"):
        bfo.block_fetch(tiles, idx.cpu(), 1)
