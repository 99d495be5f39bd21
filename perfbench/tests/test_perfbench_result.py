"""The result line's schema, and the run's refusals."""

import json
import subprocess
import sys

import pytest

from perfbench import harness
from _perfbench_tiny import ROOT, tiny_run


@pytest.fixture(scope="module")
def traced_train():
    return tiny_run("occ13.train.real", trace=True)


def test_result_line_schema(traced_train):
    run, cell = traced_train
    for trace in (False, True):
        line = harness.result_line(run, cell, trace)
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert list(line)[-1] == "checks"
        assert set(line["checks"]) == set(cell.limits)
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        assert isinstance(line["correct"], bool) and line["attempted"] > 0
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        json.dumps(line)
    e2e = harness.result_line(run, cell, False)["metrics"]
    assert set(e2e) == {"setup_s"}  # no peak memory off a card
    traced = harness.result_line(run, cell, True)
    assert set(traced["device"]) >= {"busy_s", "window_s"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU trace has no kernels: device readers return nothing, never 0
    assert set(traced["metrics"]) == {"dataset_build_s.setup", "rays_per_s.train"}


def test_the_window_counts_whole_blocks(traced_train):
    run, cell = traced_train
    assert run.work["steps"] % cell.traffic["block"] == 0
    assert run.work["rays"] == run.work["steps"] * cell.config["trainer"]["batch_size"]
    assert run.work["refreshes"] == run.work["steps"] // cell.traffic["block"]


def test_only_the_compared_steps_take_the_benchmarks_draws(monkeypatch):
    """The compared steps (through the first refresh and one after it) pass
    the benchmark's draws and the refresh's jitter; the warm-up, the window
    and the profiled steps draw from the Trainer's own streams."""
    from atmonr_tpu_torch.training.trainer import Trainer

    calls, step = [], Trainer.step

    def recorded(self, idx, draws=None, aux_jitter=None):
        calls.append((draws is not None, aux_jitter is not None, self.iter_count + 1))
        return step(self, idx, draws, aux_jitter)

    monkeypatch.setattr(Trainer, "step", recorded)
    run, cell = tiny_run("occ13.train.real", trace=True)
    every = cell.config["pipeline"]["occupancy"]["update_every"]
    assert [c[0] for c in calls] == [True] * (every + 1) + [False] * (len(calls) - every - 1)
    assert [c[2] for c in calls if c[1]] == [every]
    assert len(calls) > every + 1 + run.work["steps"]


def test_utilization_reads_the_untraced_window():
    """The MFU divides the window's FLOPs by the window's seconds, and the
    idle share sets the trace's busy seconds a step against the window's
    seconds a step: the profiler slows the host-bound step."""
    from types import SimpleNamespace

    from perfbench import spec
    from perfbench.roofline import PEAK_BF16_FLOPS

    trace = SimpleNamespace(kernels=[1], window_s=9.0, busy_s=lambda: 0.064)
    run = SimpleNamespace(device=SimpleNamespace(type="cuda"), trace=trace, window_s=2.0,
                          work={"steps": 400, "flops": 3e12, "extractions": 4},
                          traced={"steps": 32, "extractions": 2})
    mfu = spec.metric_reader("step_mfu.train")(run)
    assert mfu == pytest.approx(100 * 3e12 / 2.0 / PEAK_BF16_FLOPS)
    assert spec.metric_reader("query_mfu.extract")(run) == pytest.approx(mfu)
    idle = spec.metric_reader("device_idle_share.train")(run)
    assert idle == pytest.approx(100 * (1 - (0.064 / 32) / (2.0 / 400)))
    idle_x = spec.metric_reader("device_idle_share.extract")(run)
    assert idle_x == pytest.approx(100 * (1 - (0.064 / 2) / (2.0 / 4)))
    run.device.type = "cpu"
    assert spec.metric_reader("step_mfu.train")(run) is None


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "occ13.train.real",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_an_unknown_cell_exits_nonzero():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "no.such.cell",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_it_exits_nonzero(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/."""
    import shutil

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, time, torch\n"
            "sys.path.insert(0, '.')\n"
            "from perfbench import harness\n"
            "harness.run_cell('.', 'occ13.extract.l1c', 1, 1.0, False, torch.device('cpu'),"
            " time.perf_counter())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "atmonr_tpu_torch" in out.stderr
