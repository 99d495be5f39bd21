"""The NeRF cell ``nerf.train.real``: its files resolve by name, its work
count against the step worked out by hand, its span readers on traces with
and without the program's spans, what it loads, its inputs from one seed,
and a tiny CPU run of its runner (the result line's schema; the controls
and faults against the reference).

On the CPU the reference's own ray build and the program's host library
can round an origin differently in the last float32 bit, which moves the
scene box by an eighth of a metre; at the tiny granule's 30 km that is a
visible angle of the 2^13 pi encodings, so a tiny run's program readings
say nothing here. ``tests/test_torch_nerf_reference.py`` holds the program
to the reference on shared rays; the committed limits are set on the
card (``perfbench/calibrate.py``, ``PERF.md``)."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, inputs_nerf, spec, work_nerf
from perfbench.span_trace import SpanTrace
from _perfbench_tiny import ROOT

CELL = "nerf.train.real"
METRICS = ("rays_per_s.nerf", "launches_per_step.nerf", "device_idle_share.nerf",
           "step_mfu.nerf", "mlp_fwd_roofline.nerf", "sample_ms.nerf")
CONFIG = json.loads((ROOT / "perfbench/configs/nerf_hier.json").read_text())


def test_the_cell_resolves_by_name():
    c = spec.load_cell(ROOT, CELL)
    assert c.traffic["runner"] == "train_nerf" and callable(spec.runner("train_nerf").run)
    assert c.config["name"] == "nerf_hier" and c.entry["chips"] == 1
    assert set(c.limits) == {"loss_gap", "grad_gap", "update_gap", "depth_gap"}
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "peak_mem_mb"]
    assert [m["name"] for m in c.per_layer] == list(METRICS)
    for m in METRICS:
        assert callable(spec.metric_reader(m))


def test_the_configuration_is_the_repositorys_at_its_published_widths():
    repo = json.loads((ROOT / CONFIG["repo_file"]).read_text())
    assert all(CONFIG[k] == repo[k] for k in ("dataset", "pipeline", "trainer"))
    assert CONFIG["reduced"] == [] and CONFIG["differs_from_upstream"] == {}
    p = CONFIG["pipeline"]
    assert (CONFIG["trainer"]["batch_size"], p["sampler"], p["encoder"], p["mlp_hidden_dim"]) == (
        4096, {"N_c": 64, "N_f": 128}, {"L_x": [14, 14, 10], "L_d": 4}, 256)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "nerf_hier")
    assert entry["file"] == "perfbench/configs/nerf_hier.json" and entry["reduced"] == []


def test_the_step_is_3777_tflop():
    """Per point, coarse: 76x256 + 4 x 256x256 + 332x256 + 2 x 256x256 +
    256x257 + 280x128 + 128x4 = 599,808 multiply-adds; fine 600,576 (four
    density channels). 4,096 rays a step: 64 coarse points and 192 fine a
    ray; two FLOPs a multiply-add; three products a layer forward and
    backward."""
    per_coarse = 76 * 256 + 4 * 256 * 256 + 332 * 256 + 2 * 256 * 256 + 257 * 256 + 280 * 128 + 512
    per_fine = per_coarse + 3 * 256
    assert (per_coarse, per_fine) == (599_808, 600_576)
    macs = 4096 * (64 * per_coarse + 192 * per_fine)
    assert macs == 629_548_253_184
    w = work_nerf.train_work(CONFIG["pipeline"], 4096, 16)
    assert w["fwd_flops"] == 16 * 2 * macs and w["flops"] == 16 * 6 * macs
    assert w["flops"] / 16 / 1e12 == pytest.approx(3.777, abs=5e-4)
    assert (w["rays"], w["points"]) == (16 * 4096, 16 * 4096 * 256)
    # the step at the TF32 peak: 7.64 ms
    assert w["flops"] / 16 / work_nerf.PEAK_TF32_FLOPS * 1e3 == pytest.approx(7.636, abs=1e-3)


def _events(with_spans: bool) -> list:
    """Two kernels, launched at host times 10 and 30 on thread 1 (the
    second through the driver API), and ``nerf.mlp`` around the first
    (with ``pipeline.forward`` around both) where ``with_spans``."""
    ev = [{"ph": "X", "cat": "kernel", "name": "gemm", "ts": 100.0, "dur": 40.0,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "sort", "ts": 150.0, "dur": 10.0,
           "args": {"correlation": 2}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10.0, "dur": 1.0,
           "tid": 1, "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 30.0, "dur": 1.0,
           "tid": 1, "args": {"correlation": 2}}]
    if with_spans:
        ev += [{"ph": "X", "cat": "user_annotation", "name": "pipeline.forward", "ts": 5.0,
                "dur": 40.0, "tid": 1},
               {"ph": "X", "cat": "user_annotation", "name": "nerf.mlp", "ts": 8.0,
                "dur": 10.0, "tid": 1}]
    return ev


def test_device_time_goes_to_the_spans_open_at_its_launch():
    t = SpanTrace(_events(True), 1.0)
    assert t.device_seconds_within("nerf.mlp") == pytest.approx(40e-6)
    assert t.device_seconds_within("pipeline.forward") == pytest.approx(50e-6)
    assert t.device_seconds_by_span() == pytest.approx({"nerf.mlp": 40e-6,
                                                        "pipeline.forward": 10e-6})
    assert t.device_seconds_within("pipeline.sample") is None


def test_span_readers_return_nothing_without_the_programs_spans():
    """A program without the spans (the parent of the change that opened
    them) gives kernels and no annotations: the span metrics read None,
    the others still read."""
    traced = work_nerf.train_work(CONFIG["pipeline"], 4096, 1)
    for spans, expect in ((True, True), (False, False)):
        run = SimpleNamespace(trace=SpanTrace(_events(spans), 1.0), traced=traced,
                              device=SimpleNamespace(type="cuda"), window_s=2.0,
                              work={"steps": 10, "rays": 40960, "flops": 3.777e13})
        got = {m: spec.metric_reader(m)(run) for m in METRICS}
        assert (got["mlp_fwd_roofline.nerf"] is not None) == expect
        assert got["sample_ms.nerf"] is None
        assert got["launches_per_step.nerf"] == 2
        assert got["step_mfu.nerf"] == pytest.approx(100 * 3.777e13 / 2.0 / 494.7e12)
        assert got["device_idle_share.nerf"] == pytest.approx(100 * (1 - 50e-6 / 0.2))


def test_the_new_benchmark_files_load_nothing_of_the_program_or_of_jax():
    code = ("import sys, perfbench.reference.nerf, perfbench.inputs_nerf, perfbench.work_nerf, "
            "perfbench.span_trace\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'atmonr_tpu', 'atmonr_tpu_torch'}))")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_one_seed_gives_the_same_inputs(seed):
    dev = torch.device("cpu")
    a, b = (inputs_nerf.make_params(CONFIG["pipeline"], seed, dev) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["coarse.fc2.weight"].std().item() == pytest.approx((2 / 256) ** 0.5, rel=0.05)
    assert float(a["fine.fc6.bias"].abs().max()) <= 332**-0.5
    d1, d2 = (inputs_nerf.Draws(CONFIG["pipeline"], 5000, 64, seed, dev) for _ in range(2))
    for _ in range(80):  # across an epoch's end
        assert torch.equal(d1.rows(), d2.rows())
    x, y = d1.draws(), d2.draws()
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert {k: tuple(v.shape) for k, v in x.items()} == {
        "coarse_bins": (64, 64), "coarse_noise": (64 * 64, 1), "fine_u": (64, 128),
        "fine_noise": (64 * 192, 4)}


def _tiny_cell():
    cell = spec.load_cell(ROOT, CELL)
    cell.traffic.update(granule={"kind": "real_schema", "height": 16, "width": 12},
                        warmup_max_steps=8, block=4, trace_steps=4)
    cell.config["trainer"]["batch_size"] = 64
    cell.config["pipeline"].update(sampler={"N_c": 8, "N_f": 16}, mlp_hidden_dim=16)
    return cell


@pytest.fixture(scope="module")
def tiny():
    cell = _tiny_cell()
    return harness.run_cell(ROOT, CELL, 2**33 + 17, 0.3, True, torch.device("cpu"),
                            time.perf_counter(), cell, ("bf16", "half_batch", "coarse_only"))


def test_a_tiny_run_gives_the_result_line(tiny):
    run, cell = tiny
    assert run.work["steps"] % cell.traffic["block"] == 0 and run.failed == 0
    assert run.work["rays"] == run.work["steps"] * 64
    for trace in (False, True):
        line = harness.result_line(run, cell, trace)
        assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.limits)
        assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
        json.dumps(line)
    assert set(harness.result_line(run, cell, False)["metrics"]) == {"setup_s"}
    # the CPU trace has no kernels: device readers return nothing, never 0
    assert set(harness.result_line(run, cell, True)["metrics"]) == {"rays_per_s.nerf"}
    # the profiled steps recorded the program's spans
    assert {"nerf.coarse", "nerf.fine", "nerf.mlp", "nerf.encode", "pipeline.sample",
            "pipeline.render"} <= run.trace.span_names()


def test_controls_and_faults_read_above_the_reference_itself(tiny):
    """Against the same reference inputs, bfloat16 products move every
    compared number, half the batch the loss, the coarse loss alone the
    gradient and the update (a fine leaf's change reads 1: none)."""
    from perfbench import inputs
    from perfbench.reference import scene
    from perfbench.runners import train_nerf

    run, cell = tiny
    r = run.readings
    assert all(r["bf16"][k] > 0 for k in cell.limits)
    assert r["half_batch"]["loss_gap"] > 1e-3
    assert r["coarse_only"]["update_gap"] >= 0.99
    # the reference held to itself reads rounding alone (the first gradient
    # passes through Adam's first moment)
    granule = inputs.make_granule(cell.traffic["granule"], 5)
    sc = scene.build_scene(granule, cell.config["dataset"], torch.device("cpu"))
    p0 = inputs_nerf.make_params(cell.config["pipeline"], 5, torch.device("cpu"))
    feed = inputs_nerf.Draws(cell.config["pipeline"], sc.rays["origin"].shape[0], 64, 5,
                             torch.device("cpu"))
    checked = [{"rows": feed.rows(), "draws": feed.draws()} for _ in range(2)]
    itself = train_nerf.follow(cell.config, sc, p0, checked, None)
    gaps = train_nerf.compare(itself, train_nerf.hold(cell.config, sc, itself, checked))
    assert gaps["loss_gap"] == gaps["depth_gap"] == 0, gaps
    assert gaps["grad_gap"] < 1e-6 and gaps["update_gap"] < 1e-5, gaps
