"""Kernel K1 (``csrc/hash_gather.cu``) against its plain PyTorch version, on
the card. These tests need CUDA and ``nvcc``; they skip where there is no
card. The file imports nothing of JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from atmonr_tpu_torch.models import hash_grid as hg
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
