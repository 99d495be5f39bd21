"""The benchmark's own inputs: its granule copies equal the repository's
synthetic granules, and one seed gives the same inputs."""

import numpy as np
import pytest
import torch

from perfbench import inputs

FIELDS = ("lat", "lon", "alt", "thetav", "phiv", "i", "view_angles", "wavelengths")


def test_the_real_schema_granule_is_the_repository_one():
    from atmonr_tpu_torch.data.synthetic import real_schema_granule

    ours, theirs = inputs.real_schema_granule(16, 12, 2**33 + 1), real_schema_granule(
        16, 12, 2**33 + 1)
    assert all(np.array_equal(ours[k], getattr(theirs, k), equal_nan=True) for k in FIELDS)


def test_the_swath_granule_is_the_clis_synthetic_one():
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule

    ours, theirs = inputs.swath_granule(12, 8, 2, 5), make_synthetic_granule(12, 8, 2, seed=5)
    assert all(np.array_equal(ours[k], getattr(theirs, k), equal_nan=True) for k in FIELDS)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_one_seed_gives_the_same_inputs(seed):
    import json

    from _perfbench_tiny import ROOT

    cfg = json.loads((ROOT / "perfbench/configs/ngp_occ13.json").read_text())["pipeline"]
    spec = json.loads((ROOT / "perfbench/traffic/train.real.json").read_text())["params"]
    dev = torch.device("cpu")
    a, b = (inputs.make_params(cfg, spec, seed, dev) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(bool((a[k] >= 0).all()) for k in spec["positive_heads"])
    d1, d2 = (inputs.Draws(cfg, 5000, 256, seed, dev) for _ in range(2))
    for _ in range(25):  # across an epoch's end
        assert torch.equal(d1.rows(), d2.rows())
        x, y = d1.draws(), d2.draws()
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert float(x["fine"].max()) < 1 / 24 and x["sr_noise"].shape == a["pos_table"].shape
