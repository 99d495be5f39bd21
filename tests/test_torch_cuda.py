"""Kernels K1 (``csrc/hash_gather.cu``) and K2 (``csrc/hash_bwd.cu``) against
their plain PyTorch versions, on the card. These tests need CUDA and ``nvcc``; they skip where there is no
card. The file imports nothing of JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from atmonr_tpu_torch import Trainer, get_dataset, get_pipeline
from atmonr_tpu_torch.models import hash_grid as hg
from atmonr_tpu_torch.ops import hash_bwd as hbo
from atmonr_tpu_torch.ops import hash_gather as hgo
from atmonr_tpu_torch.ops import kernel_plan as kp

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
    before = (hgo.hash_gather.launches[(mode, n_dims)], hbo.hash_bwd.launches[n_dims])
    (got,) = torch.autograd.grad(hg.hash_encode(table, x, cfg, noise), table, g)
    torch.cuda.synchronize()
    assert (hgo.hash_gather.launches[(mode, n_dims)], hbo.hash_bwd.launches[n_dims]) == (
        before[0] + 1, before[1] + 1)
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


def _small_trainer(root, dev):
    grid = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
            "log2_hashmap_size": 9, "per_level_scale": 1.5, "fwd_mode": "q8"}
    sh = {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2}
    net = {"n_neurons": 16, "n_hidden_layers": 1}
    pipeline = {
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
        "occupancy": {"resolution": [8, 8, 4], "n_probe": 8, "n_fine": 6, "update_every": 2},
    }
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
