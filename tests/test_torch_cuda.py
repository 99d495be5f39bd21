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
    before = hgo.hash_gather_q8.launches[n_dims]
    got = hgo.hash_gather_q8(q, s, x, cfg)
    torch.cuda.synchronize()
    assert hgo.hash_gather_q8.launches[n_dims] == before + 1
    want = hgo.hash_gather_q8_plain(q, s, x, cfg)
    assert got.shape == (5000, 32)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_kernel_rejects_bad_inputs(dev):
    cfg, table, _, x = _inputs(3, 64, 1, dev)
    q, s = hgo.quantize_tables_q8(table, cfg)
    with pytest.raises(ValueError):
        hgo.hash_gather_q8(q.to(torch.int32), s, x, cfg)
    with pytest.raises(ValueError):
        hgo.hash_gather_q8(q, s, x.double(), cfg)
    with pytest.raises(ValueError):
        hgo.hash_gather_q8(q.cpu(), s, x, cfg)


def test_empty_batch(dev):
    cfg, table, _, _ = _inputs(2, 1, 2, dev)
    q, s = hgo.quantize_tables_q8(table, cfg)
    out = hgo.hash_gather_q8(q, s, torch.empty((0, 2), device=dev), cfg)
    assert out.shape == (0, 32)


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


@pytest.mark.parametrize("n_dims", [2, 3])
def test_q8_autograd_runs_both_kernels(dev, n_dims):
    """The table gradient of the q8 encode on the card is K2, whatever the
    rounding noise, and agrees with the plain version on the CPU."""
    cfg, table, noise, x = _inputs(n_dims, 3000, 30 + n_dims, dev)
    table.requires_grad_()
    g = torch.from_numpy(np.random.default_rng(21).normal(size=(3000, 32)).astype(np.float32)).to(dev)
    before = (hgo.hash_gather_q8.launches[n_dims], hbo.hash_bwd.launches[n_dims])
    (got,) = torch.autograd.grad(hg.hash_encode(table, x, cfg, noise), table, g)
    torch.cuda.synchronize()
    assert (hgo.hash_gather_q8.launches[n_dims], hbo.hash_bwd.launches[n_dims]) == (
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
    before = (dict(hgo.hash_gather_q8.launches), dict(hbo.hash_bwd.launches))
    losses = []
    for it in first.iterate(tmp_path / "out"):
        losses.append(first.last_loss)
        if it == 4:
            first._preempted = True
    assert first.iter_count == 4
    assert hbo.hash_bwd.launches == {d: before[1][d] + 4 for d in (2, 3)}
    assert hgo.hash_gather_q8.launches == {2: before[0][2] + 4, 3: before[0][3] + 4 + 2}
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
