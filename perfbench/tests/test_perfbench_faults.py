"""The comparison that decides ``correct``, driven through a whole tiny run
on the CPU (the look for a card skipped) with the timed path broken
underneath: each fault the cells can have makes ``correct`` false, reading
far above both the committed limit and the unbroken program's own gap. The
lower-precision controls are read on the card at the cells' own sizes
(``perfbench/calibrate.py``, the ``cuda`` test below; ``PERF.md``); here
they run at the tiny size."""

import time

import pytest
import torch

from perfbench import harness, spec
from _perfbench_tiny import CPU_TOLERANCE, ROOT, tiny_run

TRAIN = ("occ13.train.real",)
CONTROLS = [("occ13.train.real", "table:q4"),
            ("occ13.extract.l1c", "grid:f32+table:q4")]


@pytest.fixture(scope="module")
def unbroken():
    return {cell: tiny_run(cell)[0].readings for cell in TRAIN + ("occ13.extract.l1c",)}


@pytest.mark.parametrize("cell", TRAIN + ("occ13.extract.l1c",))
def test_the_reference_agrees_with_the_port_on_the_cpu(cell, unbroken):
    readings = unbroken[cell]
    assert set(readings) == set(spec.load_cell(ROOT, cell).limits)
    assert all(readings[k] <= CPU_TOLERANCE[k] for k in readings), readings


def _caught(cell, run, c, unbroken, number):
    ok, checks = harness.judge(run, c.limits)
    assert not ok, checks
    assert run.readings[number] > max(c.limits[number], 5 * unbroken[cell][number]), \
        (run.readings, unbroken[cell])


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_caught(cell, unbroken, monkeypatch):
    from atmonr_tpu_torch.training.optim import ClippedAdamW

    def frozen(self):
        self.count += 1

    monkeypatch.setattr(ClippedAdamW, "step", frozen)
    run, c = tiny_run(cell)
    _caught(cell, run, c, unbroken, "update_gap")
    assert run.readings["update_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_caught(cell, unbroken, monkeypatch):
    from atmonr_tpu_torch.pipelines.instant_ngp import InstantNGPPipeline

    whole = InstantNGPPipeline.compute_loss

    def half(self, batch, results):
        n = batch["rad"].shape[0] // 2
        return whole(self, {k: v[:n] for k, v in batch.items()},
                     {k: v[:n] for k, v in results.items()})

    monkeypatch.setattr(InstantNGPPipeline, "compute_loss", half)
    run, c = tiny_run(cell)
    _caught(cell, run, c, unbroken, "loss_gap")


@pytest.mark.parametrize("cell", TRAIN)
def test_a_skipped_occupancy_refresh_is_caught(cell, unbroken, monkeypatch):
    """The grid stays as it was at the refresh: the steps after it sample
    from a stale grid."""
    from atmonr_tpu_torch.pipelines.instant_ngp import InstantNGPPipeline

    monkeypatch.setattr(InstantNGPPipeline, "update_aux", lambda self, **kw: None)
    run, c = tiny_run(cell)
    _caught(cell, run, c, unbroken, "occ_gap")
    assert run.readings["occ_gap"] == pytest.approx(1.0)


def test_an_altered_answer_is_caught(unbroken, monkeypatch):
    from atmonr_tpu_torch.pipelines.instant_ngp import InstantNGPPipeline

    exact = InstantNGPPipeline.extract

    def altered(self, pts):
        out = exact(self, pts).clone()
        out[0] += out.abs().max()  # one answer of every batch
        return out

    monkeypatch.setattr(InstantNGPPipeline, "extract", altered)
    run, c = tiny_run("occ13.extract.l1c")
    _caught("occ13.extract.l1c", run, c, unbroken, "sigma_gap")


@pytest.mark.parametrize("cell,variant", CONTROLS)
def test_the_lower_precision_control_at_the_tiny_size(cell, variant, unbroken):
    """The control in the program's place reads above the program's own
    gap on the same inputs, on one of the compared numbers at least."""
    run, c = tiny_run(cell, variants=(variant,))
    control = run.readings[variant]
    assert any(control[k] > 1.5 * unbroken[cell][k] for k in c.limits), (control, unbroken[cell])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", CONTROLS)
def test_the_control_fails_at_the_cells_size_on_the_card(cell, variant):
    """On the card, at the cell's own size: the control fails one of the
    cell's limits on three seeds, and the program passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the card")
    limits = spec.load_cell(ROOT, cell).limits
    for seed in (2**32 + 3, 2**32 + 5, 2**32 + 7):
        run, _ = harness.run_cell(ROOT, cell, seed, 1.0, False, torch.device("cuda", 0),
                                  time.perf_counter(), variants=(variant,))
        control = run.readings[variant]
        assert any(control[k] > lim for k, lim in limits.items()), (seed, control, limits)
        assert all(run.readings[k] <= lim for k, lim in limits.items()), (seed, run.readings)
