"""The operations and bytes the roofline and utilization metrics count,
against values worked out by hand."""

import pytest

from perfbench import roofline, work
from perfbench.reference.ngp import Grid

FLAGSHIP_POS = Grid(3, 16, 2, 13, 16, 1.3819, "q8")
REF_POS = Grid(3, 16, 2, 21, 16, 1.3819, "bf16")


def test_table_rows():
    # the flagship's 2^13 levels (the coarse ones dense) and the 2^21 grid
    assert FLAGSHIP_POS.rows == 126_976
    assert REF_POS.rows == 21_141_696


def test_k1_q8_bound_at_the_flagship_points():
    # 196,608 points (8,192 rays x 24 samples): int8 table 126,976 x 2 B,
    # points 196,608 x 3 x 4 B, features 196,608 x 32 x 4 B
    flops, nbytes = roofline.encode_fwd(196_608, 3, 16, 2, 126_976, table_bytes=1)
    assert nbytes == 253_952 + 2_359_296 + 25_165_824
    assert roofline.least_seconds(flops, nbytes) * 1e3 == pytest.approx(0.0083, abs=5e-5)
    # 8 corners x (2 weight products + 2 x 2 multiply-adds) per point and level
    assert flops == 196_608 * 16 * 8 * 6


def test_k2_bound_at_2_21():
    # points, float32 cotangents, the float32 gradient table of 21,141,696 rows
    flops, nbytes = roofline.encode_bwd(196_608, 3, 16, 2, 21_141_696)
    assert nbytes == 2_359_296 + 25_165_824 + 169_133_568
    assert roofline.least_seconds(flops, nbytes) * 1e3 == pytest.approx(0.0587, abs=5e-5)


def test_encode_fwd_counts_the_master_table_and_its_noise():
    _, plain = roofline.encode_fwd(10, 3, 16, 2, 1000)
    _, noisy = roofline.encode_fwd(10, 3, 16, 2, 1000, noise=True)
    assert plain == 1000 * 2 * 4 + 10 * 3 * 4 + 10 * 32 * 4
    assert noisy - plain == 1000 * 2 * 4


def test_mlp_flops():
    assert roofline.mlp_flops(10, [(32, 19), (4, 32)], False) == 2 * 10 * (32 * 19 + 4 * 32)
    assert roofline.mlp_flops(10, [(32, 19)], True) == 3 * 2 * 10 * 32 * 19


def test_train_work_of_the_flagship_step():
    import json

    from _perfbench_tiny import ROOT

    cfg = json.loads((ROOT / "perfbench/configs/ngp_occ13.json").read_text())["pipeline"]
    w = work.train_work(cfg, 8192, 16, 1)
    pos, surf, refresh = w["encode_fwd"]
    assert pos == ({"points": 196_608, "dims": 3, "levels": 16, "features": 2,
                    "rows": 126_976, "noise": True}, 16)
    assert surf[0]["dims"] == 2 and surf[0]["points"] == 8192 and surf[1] == 16
    assert refresh == ({"points": 131_072, "dims": 3, "levels": 16, "features": 2,
                        "rows": 126_976, "noise": False}, 1)
    # MLP products a step: 196,608 points through the density MLP (32-32-32-16)
    # and the color MLP (19-32-32-32-4), 8,192 rays through the surface MLP
    # (36-32-32-32-4), forward and backward
    per_step = 3 * 2 * (196_608 * (32 * 32 + 32 * 32 + 16 * 32)
                        + 196_608 * (32 * 19 + 32 * 32 + 32 * 32 + 4 * 32)
                        + 8192 * (32 * 36 + 32 * 32 + 32 * 32 + 4 * 32))
    refresh_mlp = 2 * 131_072 * (32 * 32 + 32 * 32 + 16 * 32)
    interp = (16 * roofline.encode_fwd(196_608, 3, 16, 2, 1)[0]
              + 16 * roofline.encode_fwd(8192, 2, 16, 2, 1)[0]
              + roofline.encode_fwd(131_072, 3, 16, 2, 1)[0]
              + 16 * roofline.encode_bwd(196_608, 3, 16, 2, 1)[0]
              + 16 * roofline.encode_bwd(8192, 2, 16, 2, 1)[0])
    assert w["flops"] == pytest.approx(16 * per_step + refresh_mlp + interp)


def test_query_work_splits_the_tail_batch():
    import json

    from _perfbench_tiny import ROOT

    cfg = json.loads((ROOT / "perfbench/configs/ngp_occ13.json").read_text())["pipeline"]
    w = work.query_work(cfg, 6_561_792, 32_768, 2)
    (full, n_full), (tail, n_tail) = w["encode_fwd"]
    assert (full["points"], n_full, tail["points"], n_tail) == (32_768, 400, 8_192, 2)
