"""The port's pair-bucket Instant-NGP (``configs/instant_ngp_occ21_pb.json``,
``hashed_tile: "on"``) against the benchmark's plain reference
(``perfbench/reference/ngp_pb.py``), on the CPU at a small cut: both hash
grids cut to 4 levels of 2^9 rows from base resolution 4 at growth 2, so
the two coarse position levels are dense and the two fine ones hashed into
8 buckets of 64 rows, 64 rays a step, the benchmark's seeded parameters
and draws (``perfbench/inputs.py``).

The encode is held to the reference bit for bit, points whose cell base
sits at a window's last stride (``base % 3 == 2``) among them. Three
``Trainer.step``s and the occupancy refresh at the second run through the
benchmark's own runner (``perfbench/runners/train_pb.py``) and its
comparison (each step taken by the reference from the program's state),
with the reference's ordinary spatial hash (``hash:plain``) as the planted
fault. The exact path's gradients, now taken inside the
span ``hash_encode.bwd``, equal autograd's through ``_hash_encode_exact``
bit for bit."""

import json
import time
from pathlib import Path

import pytest
import torch

from _torch_threads import one_torch_thread
from atmonr_tpu_torch.models import hash_grid as hg
from perfbench import harness, spec
from perfbench.reference import ngp, ngp_pb

REPO = Path(__file__).resolve().parent.parent
CELL = "occ21pb.train.real"
SEED = 2**33 + 41
CUT = {"n_levels": 4, "log2_hashmap_size": 9, "base_resolution": 4, "per_level_scale": 2.0}
# The unbroken program's largest readings here. On the CPU the reference's
# bfloat16 MLP products accumulate in another order than the port's (a
# bfloat16 ulp is 4e-3 of a value), and its float64 ray build and the
# port's host library round the normalisation box an eighth of a metre
# apart: the first steps' loss and leaf norms part by up to ~1e-3. The
# refreshed grid is computed by both from the program's own parameters and
# agrees to rounding. The card's limits are the cell's own
# (``perfbench/workloads/occ21pb.train.real.json``).
CPU_TOLERANCE = {"loss_gap": 5e-3, "grad_gap": 1e-2, "update_gap": 3e-2, "occ_gap": 1e-4}


def _grid_options(base: dict) -> dict:
    return dict(base, **CUT)


def _cut_cell() -> spec.Cell:
    cell = spec.load_cell(REPO, CELL)
    ngp_cfg = cell.config["pipeline"]["instant_ngp"]
    ngp_cfg["encoding"].update(CUT)
    ngp_cfg["surface_encoding"]["nested"][0].update(CUT)
    cell.config["pipeline"]["occupancy"]["update_every"] = 2  # a refresh at the second step
    cell.config["trainer"]["batch_size"] = 64
    cell.traffic["granule"] = {"kind": "real_schema", "height": 16, "width": 12}
    cell.traffic.update(warmup_max_steps=16, trace_steps=4)
    return cell


@pytest.fixture(scope="module")
def steps():
    """One tiny run of the cell on the CPU, with the planted fault read
    against the same reference."""
    with one_torch_thread():
        run, _ = harness.run_cell(REPO, CELL, SEED, 0.2, False, torch.device("cpu"),
                                  time.perf_counter(), _cut_cell(), ("hash:plain",))
    return run


def test_the_configuration_is_the_published_size_with_pair_buckets():
    """16 levels of 2 features, 21,141,696 position rows: levels 0-6 dense,
    the 9 hashed levels pair-bucket at 2^21 / 64 = 32,768 buckets; the 2-D
    surface grid keeps the plain hash; the cut keeps two dense and two
    pair-bucket levels."""
    pipeline = json.loads((REPO / "perfbench/configs/ngp_occ21_pb.json").read_text())["pipeline"]
    ngp_cfg = pipeline["instant_ngp"]
    pos = ngp.Grid.of(ngp_cfg["encoding"], 3)
    assert (pos.levels, pos.features, pos.rows, pos.stored) == (16, 2, 21_141_696, "bf16")
    assert [ngp_pb.pair_bucket(pos, level) for level in range(16)] == [False] * 7 + [True] * 9
    assert {pos.sizes[level] // ngp_pb.BUCKET for level in range(7, 16)} == {32_768}
    surf = ngp.Grid.of(ngp_cfg["surface_encoding"]["nested"][0], 2)
    assert not any(ngp_pb.pair_bucket(surf, level) for level in range(16))
    cut = ngp.Grid.of(_grid_options(ngp_cfg["encoding"]), 3)
    assert [ngp_pb.pair_bucket(cut, level) for level in range(4)] == [False, False, True, True]
    model = ngp_pb.Model(pipeline, scene=None)
    assert model.hashing == "pair_bucket"
    assert hg.resolve_fwd_mode(hg.HashGridConfig.from_options(ngp_cfg["encoding"], 3)) == "xla_bf16"


def _encode_case(seed: int, m: int = 4096):
    options = _grid_options({"n_features_per_level": 2, "hashed_tile": "on"})
    cfg = hg.HashGridConfig.from_options(options, 3)
    grid = ngp.Grid.of(options, 3)
    g = torch.Generator().manual_seed(seed)
    table = (torch.rand((cfg.total_params, 2), generator=g) * 2 - 1).requires_grad_(True)
    x = torch.rand((m, 3), generator=g)
    return cfg, grid, table, x


@pytest.mark.parametrize("seed", [3, 11])
def test_the_pair_bucket_encode_equals_the_reference(seed):
    """The port's rows and weights equal the reference's at every level,
    points at every in-window stride included, and its encode (the exact
    gather over the bf16-rounded table) equals the reference's bit for
    bit; the plain spatial hash reads other rows on the hashed levels."""
    cfg, grid, table, x = _encode_case(seed)
    for level in range(grid.levels):
        idx, w = hg.level_indices(x, cfg, level)
        want, want_w = ngp_pb.corners_and_weights(x, grid, level, "pair_bucket")
        assert torch.equal(idx + cfg.level_offsets[level], want) and torch.equal(w, want_w)
        if ngp_pb.pair_bucket(grid, level):
            base = torch.clamp(torch.floor(x * grid.scale(level) + 0.5), 0,
                               grid.resolution(level) - 2).long()
            assert set((base % 3).unique().tolist()) == {0, 1, 2}
            at_last = (base % 3 == 2).any(1)
            assert int(at_last.sum()) > 100
            plain, _ = ngp_pb.corners_and_weights(x, grid, level, "plain")
            assert (plain != want).any(1).float().mean() > 0.9
    with torch.no_grad():
        got = hg.hash_encode(table, x, cfg)
        want = ngp_pb.encode(table, x, grid, "bf16", "pair_bucket")
    assert torch.equal(got, want)


def test_three_steps_and_a_refresh_match_the_reference(steps):
    """Steps 1-3 (the loss, the first gradient's and the change's leaf
    norms) and the refresh at step 2 within the CPU tolerances."""
    got = {k: steps.readings[k] for k in CPU_TOLERANCE}
    assert all(got[k] <= CPU_TOLERANCE[k] for k in got), got
    assert steps.failed == 0 and steps.work["steps"] > 0


def test_a_reference_with_the_plain_hash_is_caught(steps):
    """The reference with the ordinary spatial hash on the hashed levels
    reads the loss, the change and the refreshed grid far above the
    tolerances and the program's own gaps."""
    plain, own = steps.readings["hash:plain"], steps.readings
    for k in ("loss_gap", "update_gap", "occ_gap"):
        assert plain[k] > max(CPU_TOLERANCE[k], 5 * own[k]), (k, plain, own)


@pytest.mark.parametrize("positions", [False, True], ids=["table", "table and positions"])
@pytest.mark.parametrize("fwd_mode", ["auto", "xla"])
def test_the_exact_gathers_gradients_equal_autograds(fwd_mode, positions):
    """``hash_encode`` on the exact path (``xla_bf16`` for ``auto``, and
    ``xla``) against autograd through ``_hash_encode_exact`` (behind the
    straight-through bf16 rounding for ``xla_bf16``): the values and the
    gradients of the table and of the positions equal bit for bit. On one
    thread: the CPU's threaded index backward sums a row's duplicate
    corners in a varying order, so two runs of autograd itself differ in
    the last bits."""
    options = _grid_options({"n_features_per_level": 2, "hashed_tile": "on",
                             "fwd_mode": fwd_mode})
    cfg = hg.HashGridConfig.from_options(options, 3)
    mode = hg.resolve_fwd_mode(cfg)
    assert mode == {"auto": "xla_bf16", "xla": "xla"}[fwd_mode]
    g = torch.Generator().manual_seed(5)
    table0 = torch.rand((cfg.total_params, 2), generator=g) * 2 - 1
    x0 = torch.rand((3000, 3), generator=g)
    cot = torch.randn((3000, 8), generator=g)

    def grads(encode):
        table = table0.clone().requires_grad_(True)
        x = x0.clone().requires_grad_(positions)
        out = encode(table, x)
        out.backward(cot)
        return out.detach(), table.grad, x.grad

    def autograd(table, x):
        if mode == "xla_bf16":
            table = table + (table.to(torch.bfloat16).to(table.dtype) - table).detach()
        return hg._hash_encode_exact(table, x, cfg)

    with one_torch_thread():
        got, want = grads(lambda t, x: hg.hash_encode(t, x, cfg)), grads(autograd)
    for a, b in zip(got, want):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    assert (got[2] is not None) == positions


@pytest.mark.parametrize("positions", [False, True], ids=["table", "table and positions"])
def test_the_exact_gather_keeps_the_positions_only_for_their_gradient(positions):
    """The backward's context holds the table's alias and the positions'
    only where they take a gradient: autograd's own graph of the gather
    keeps no reference to positions that take none, so the caller's
    points (2.4 MB a step at the cell's 196,608) are freed as before."""
    cfg, _, table, x = _encode_case(7, 64)
    out = hg.hash_encode(table, x.requires_grad_(positions), cfg)
    held = out.grad_fn.leaves
    assert held[0] is not None and held[0].data_ptr() == table.data_ptr()
    assert (held[1] is not None) == positions
