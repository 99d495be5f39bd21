"""The span recorder (``atmonr_tpu_torch/utils/spans.py``) and the spans
of the train step and the extraction, on the CPU: off, the shared no-op;
on, nesting, parents and step ids across threads, ``record_function`` only
under an active profiler, the summary; a small Instant-NGP Trainer's steps
and ``run_extraction``'s batches with the recorder on and off; the spans in
``Trainer.iterate(profile=True)``'s trace; a small hierarchical NeRF's
passes, in its train steps and its extraction; the exact gather's spans
and its call counter."""

import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from atmonr_tpu_torch import (
    Trainer, get_dataset, get_extract_dataset, get_pipeline, run_extraction,
)
from atmonr_tpu_torch.utils.config import load_config
from atmonr_tpu_torch.utils import spans
from test_torch_pipeline import N_RAYS, SCENE
from test_torch_train import _make_trainer

STEPS = 4  # the small Trainer refreshes its occupancy grid every 2


def _by_name(records) -> dict:
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_records_nothing_and_returns_the_shared_no_op():
    a, b = spans.span("x", count=3), spans.span("y", step=1)
    assert a is b
    with a as s:
        s.count = 5  # ignored
    assert s.count is None
    with spans.recording() as records:
        pass
    with spans.span("after"):
        pass
    assert records == []
    assert spans.span("z") is a


def test_recording_nests_spans_with_parents_and_step_ids():
    with spans.recording() as records:
        with spans.span("outside"):
            pass
        with spans.span("step", count=8, step=7, cpu=True) as st:
            with spans.span("child") as child:
                with spans.span("grandchild", count=2):
                    pass
                child.count = 4
        with spans.span("after"):
            pass
    r = {x.name: x for x in records}
    assert [x.name for x in records] == ["outside", "grandchild", "child", "step", "after"]
    assert len({x.id for x in records}) == 5
    assert r["outside"].parent is None and r["outside"].step is None
    assert r["step"].parent is None and r["step"].step == 7 and r["step"].count == 8
    assert r["child"].parent == st.id and r["child"].step == 7 and r["child"].count == 4
    assert r["grandchild"].parent == child.id and r["grandchild"].step == 7
    assert r["after"].parent is None and r["after"].step is None
    me = threading.get_ident()
    for x in records:
        assert x.thread == me and x.start_ns <= x.end_ns
        assert (x.cpu_ns is not None) == (x.name == "step")  # read where asked only
    assert r["step"].cpu_ns >= 0
    assert r["step"].start_ns <= r["child"].start_ns <= r["grandchild"].start_ns
    assert r["grandchild"].end_ns <= r["child"].end_ns <= r["step"].end_ns


def test_a_span_on_another_thread_takes_the_open_steps_innermost_span():
    """As autograd's device thread does while the calling thread waits in
    ``backward()``: its span's parent is the step thread's innermost open
    span, and it takes that step's id. With no step open, it has none."""
    def worker(name):
        with spans.span(name):
            with spans.span(name + ".inner"):
                pass

    with spans.recording() as records:
        with spans.span("trainer.step", step=3):
            with spans.span("trainer.backward") as bwd:
                t = threading.Thread(target=worker, args=("hash_encode.bwd",))
                t.start()
                t.join(timeout=30)
        t2 = threading.Thread(target=worker, args=("idle",))
        t2.start()
        t2.join(timeout=30)
    assert not t.is_alive() and not t2.is_alive()
    r = {x.name: x for x in records}
    assert r["hash_encode.bwd"].parent == bwd.id and r["hash_encode.bwd"].step == 3
    assert r["hash_encode.bwd"].thread != bwd.thread
    assert r["hash_encode.bwd.inner"].parent == r["hash_encode.bwd"].id
    assert r["hash_encode.bwd.inner"].step == 3
    assert r["idle"].parent is None and r["idle"].step is None


def test_record_function_only_while_recording_under_an_active_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with spans.recording():
        with spans.span("no_profiler"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("recorder_off"):
            pass
        with spans.recording():
            with spans.span("both_on"):
                torch.ones(4).sum()
    assert entered == ["both_on"]
    names = {e.name for e in prof.events()}
    assert "both_on" in names and "recorder_off" not in names


def test_recording_does_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError, match="already"):
            with spans.recording():
                pass
    assert spans.span("x") is spans.span("y")


def test_summary_self_time_off_cpu_and_counts():
    """Self time is the wall less the union of the children's intervals
    inside it (two children on two threads overlap); off-CPU is the wall
    less the thread's CPU time, over the spans that read it."""
    rec = lambda i, name, parent, s, e, cpu, count=None: SimpleNamespace(  # noqa: E731
        id=i, name=name, parent=parent, start_ns=s, end_ns=e, cpu_ns=cpu, count=count)
    records = [
        rec(0, "step", None, 0, 100_000, 40_000, 8),
        rec(1, "child", 0, 10_000, 40_000, 30_000, 3),
        rec(2, "child", 0, 30_000, 60_000, 0, 5),
        rec(3, "leaf", 2, 35_000, 45_000, None),
        rec(4, "step", None, 200_000, 300_000, 100_000, 8),
    ]
    s = spans.summary(records)
    assert s["step"]["calls"] == 2 and s["step"]["count"] == 16
    assert s["step"]["wall_s"] == pytest.approx(200e-6)
    assert s["step"]["self_s"] == pytest.approx((100_000 - 50_000 + 100_000) * 1e-9)
    assert s["step"]["off_cpu_s"] == pytest.approx(60e-6)
    assert s["child"]["calls"] == 2 and s["child"]["count"] == 8
    assert s["child"]["self_s"] == pytest.approx(50e-6)
    assert s["child"]["off_cpu_s"] == pytest.approx(30e-6)
    assert s["leaf"]["count"] is None and s["leaf"]["self_s"] == pytest.approx(10e-6)
    assert s["leaf"]["off_cpu_s"] is None


def test_summary_of_recorded_spans_sees_a_wait_off_the_cpu():
    with spans.recording() as records:
        with spans.span("outer"):
            with spans.span("wait", cpu=True):
                time.sleep(0.03)
    s = spans.summary(records)
    assert s["wait"]["off_cpu_s"] >= 0.025
    assert s["outer"]["wall_s"] >= s["wait"]["wall_s"]
    assert s["outer"]["self_s"] == pytest.approx(s["outer"]["wall_s"] - s["wait"]["wall_s"])


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Two Trainers of one seed, ``STEPS`` steps on the same rows: one
    with the recorder on, one with it off."""
    out = {}
    idx = torch.from_numpy(np.random.default_rng(5).permutation(N_RAYS * 2)[:N_RAYS])
    for on in (True, False):
        tr = _make_trainer(tmp_path_factory.mktemp("spans"), name=f"on{on}")
        losses = []
        if on:
            with spans.recording() as records:
                for _ in range(STEPS):
                    losses.append(tr.step(idx))
            out["records"] = records
        else:
            for _ in range(STEPS):
                losses.append(tr.step(idx))
        out[on] = (tr, losses)
    return out


def test_each_step_has_one_of_each_phase(steps):
    by = _by_name(steps["records"])
    for name in ("trainer.step", "pipeline.forward", "pipeline.loss", "trainer.backward",
                 "optim.step", "pipeline.sample", "pipeline.render", "trainer.progress"):
        assert sorted(r.step for r in by[name]) == list(range(1, STEPS + 1)), name
    # gather and draws
    assert sorted(r.step for r in by["trainer.batch"]) == sorted(list(range(1, STEPS + 1)) * 2)
    assert sorted(r.step for r in by["occupancy.refresh"]) == [2, 4]
    assert all(r.count == N_RAYS for r in by["trainer.step"])
    assert {r.step for r in by["hash_encode.fwd"]} == set(range(1, STEPS + 1))
    assert {r.step for r in by["hash_encode.bwd"]} == set(range(1, STEPS + 1))
    # no span of the step reads the thread's CPU clock (a system call)
    assert all(r.cpu_ns is None for r in steps["records"])


def test_step_spans_nest_inside_their_parents(steps):
    records = steps["records"]
    of = {r.id: r for r in records}
    step_children = {"trainer.batch", "pipeline.forward", "pipeline.loss", "trainer.backward",
                     "trainer.progress", "optim.step", "occupancy.refresh"}
    for r in records:
        if r.name == "trainer.step":
            assert r.parent is None
            continue
        p = of[r.parent]
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (r.name, p.name)
        assert r.step == p.step
        if r.name in step_children:
            assert p.name == "trainer.step", r.name
        if r.name in ("pipeline.sample", "pipeline.render"):
            assert p.name == "pipeline.forward"
        if r.name == "hash_encode.bwd":  # on the CPU, autograd runs on the calling thread
            assert p.name == "trainer.backward"
        if r.name == "hash_encode.fwd":
            assert p.name in ("pipeline.forward", "occupancy.refresh")


def test_losses_and_parameters_equal_with_the_recorder_on_and_off(steps):
    (on, l_on), (off, l_off) = steps[True], steps[False]
    assert [float(x) for x in l_on] == [float(x) for x in l_off]
    for (n, a), (_, b) in zip(on.pipeline.named_parameters(), off.pipeline.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(on.pipeline.occ, off.pipeline.occ)


def test_extraction_spans_cover_each_batch(tmp_path):
    tr = _make_trainer(tmp_path)
    with spans.recording() as records:
        grid = get_extract_dataset("l1c", tr.dataset, alt_step=2000.0)
        sigma = run_extraction(tr.pipeline, grid, batch_size=100)
    n = len(grid)
    assert n > 300 and n % 100
    by = _by_name(records)
    assert by["extract.grid"][0].count == n
    (query,) = by["extract.query"]
    assert query.count == n
    batches = by["extract.batch"]
    assert len(batches) == -(-n // 100)
    assert sum(b.count for b in batches) == n
    # the points are normalized a batch at a time, inside the batch's query
    assert "extract.normalize" not in by and len(by["extract.to_host"]) == 1
    # one copy in for each batch, inside it, counting the batch's rows
    to_device, of = by["extract.to_device"], {b.id: b for b in batches}
    assert len(to_device) == len(batches) and {r.parent for r in to_device} == set(of)
    assert all(r.count == of[r.parent].count for r in to_device)
    # the few long spans read the CPU clock, the batches and their copies in do not
    for name in ("extract.grid", "extract.query", "extract.to_host"):
        assert by[name][0].cpu_ns is not None, name
    assert all(r.cpu_ns is None for r in batches + to_device)
    for r in records:
        if r.name.startswith("extract.") and r.name not in ("extract.grid", "extract.grid.points",
                                                            "extract.query", "extract.to_device"):
            assert r.parent == query.id, r.name
    np.testing.assert_array_equal(sigma, run_extraction(tr.pipeline, grid, batch_size=100))


def test_l1c_grid_build_records_its_points_span(tmp_path):
    """One ``extract.grid.points`` span inside ``extract.grid``, counting
    every point, with no CPU clock."""
    tr = _make_trainer(tmp_path)
    with spans.recording() as records:
        grid = get_extract_dataset("l1c", tr.dataset, alt_step=2000.0)
    by = _by_name(records)
    (build,), (points,) = by["extract.grid"], by["extract.grid.points"]
    assert points.parent == build.id
    assert points.count == len(grid) > 0 and points.cpu_ns is None
    assert build.start_ns <= points.start_ns <= points.end_ns <= build.end_ns


def test_dataset_build_counts_the_rays(tmp_path):
    with spans.recording() as records:
        tr = _make_trainer(tmp_path)
    (build,) = _by_name(records)["dataset.build"]
    assert build.count == len(tr.dataset) > 0 and build.cpu_ns is not None


def test_profiled_epoch_trace_carries_the_step_spans(tmp_path):
    tr = _make_trainer(tmp_path, num_iters=4, batch_size=N_RAYS)
    epoch = tr.steps_per_epoch
    tr.num_iters = epoch + 1  # the profile covers the first epoch only
    tr.train(tmp_path / "out", profile=True)
    events = json.loads((tr.tensorboard_dir / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("trainer.step") == epoch
    assert names.count("pipeline.forward") == epoch
    assert spans.span("after") is spans.span("again")  # the recorder is off again


def test_a_profiled_loop_left_early_turns_the_recorder_off(tmp_path):
    tr = _make_trainer(tmp_path, num_iters=8, batch_size=N_RAYS)
    for it in tr.iterate(tmp_path / "out", profile=True):
        assert spans.span("a") is not spans.span("b")  # on while profiling
        break
    assert spans.span("a") is spans.span("b")


# -- the hierarchical NeRF ---------------------------------------------------------

NERF_PASSES = {"coarse": 8, "fine": 8 + 16}  # points a ray through each pass's MLP


def _nerf_trainer(root, name):
    """``configs/nerf.json`` at 8 + 16 samples, 16 wide, ``N_RAYS`` a step."""
    config = load_config(Path(__file__).resolve().parent.parent / "configs" / "nerf.json")
    config["pipeline"].update(sampler={"N_c": 8, "N_f": 16}, mlp_hidden_dim=16)
    ds = get_dataset(config["dataset"], SCENE, device="cpu")
    pipe = get_pipeline(config["pipeline"], ds, device="cpu")
    return Trainer(dict(config["trainer"], batch_size=N_RAYS), ds, pipe, name, root, seed=3,
                   device="cpu")


@pytest.fixture(scope="module")
def nerf_steps(tmp_path_factory):
    """Two NeRF Trainers of one seed, two steps on the same rows: one with
    the recorder on, one with it off."""
    out = {}
    idx = torch.arange(N_RAYS)
    for on in (True, False):
        tr = _nerf_trainer(tmp_path_factory.mktemp("nerf_spans"), f"nerf{on}")
        if on:
            with spans.recording() as records:
                losses = [tr.step(idx) for _ in range(2)]
            out["records"] = records
        else:
            losses = [tr.step(idx) for _ in range(2)]
        out[on] = (tr, losses)
    return out


def test_each_nerf_pass_opens_its_spans_with_counts(nerf_steps):
    """A pass is ``nerf.<pass>`` under ``pipeline.forward``, holding one
    each of ``pipeline.sample`` and ``pipeline.render`` (rays) and
    ``nerf.encode`` and ``nerf.mlp`` (points), in that order; none reads
    the CPU clock."""
    records = nerf_steps["records"]
    of, by = {r.id: r for r in records}, _by_name(records)
    for mode, n in NERF_PASSES.items():
        passes = by[f"nerf.{mode}"]
        assert sorted(r.step for r in passes) == [1, 2]
        for p in passes:
            assert of[p.parent].name == "pipeline.forward" and p.count == N_RAYS * n
            inner = sorted((r for r in records if r.parent == p.id), key=lambda r: r.start_ns)
            assert [r.name for r in inner] == ["pipeline.sample", "nerf.encode", "nerf.mlp",
                                               "pipeline.render"], mode
            assert [r.count for r in inner] == [N_RAYS, N_RAYS * n, N_RAYS * n, N_RAYS]
            for r in inner:
                assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns and r.step == p.step
    coarse, fine = by["nerf.coarse"][0], by["nerf.fine"][0]
    assert coarse.end_ns <= fine.start_ns  # the fine pass samples from the coarse weights
    assert all(r.cpu_ns is None for r in records)


def test_nerf_steps_equal_with_the_recorder_on_and_off(nerf_steps):
    (on, l_on), (off, l_off) = nerf_steps[True], nerf_steps[False]
    assert [float(x) for x in l_on] == [float(x) for x in l_off]
    for (n, a), (_, b) in zip(on.pipeline.named_parameters(), off.pipeline.named_parameters()):
        assert torch.equal(a, b), n


def test_nerf_spans_are_the_shared_no_op_when_off(nerf_steps, monkeypatch):
    """Outside ``recording()`` the passes open nothing: every ``span`` call
    of a step returns the one shared no-op."""
    tr, _ = nerf_steps[False]
    returned, real = [], spans.span

    def watching(*args, **kwargs):
        returned.append(real(*args, **kwargs))
        return returned[-1]

    monkeypatch.setattr(spans, "span", watching)
    tr.step(torch.arange(N_RAYS))
    assert len(returned) >= 8 and all(r is spans._NO_SPAN for r in returned)


def test_nerf_extraction_opens_encode_and_mlp_spans(nerf_steps):
    tr, _ = nerf_steps[False]
    pts = torch.rand((37, 3)) * 2 - 1
    with spans.recording() as records:
        sigma = tr.pipeline.extract(pts)
    by = _by_name(records)
    (enc,), (mlp,) = by["nerf.encode"], by["nerf.mlp"]
    assert enc.count == mlp.count == 37 and enc.end_ns <= mlp.start_ns
    assert torch.equal(sigma, tr.pipeline.extract(pts))


def _exact_case(options: dict, n_dims: int, m: int = 300):
    from atmonr_tpu_torch.models import hash_grid as hg

    cfg = hg.HashGridConfig.from_options(dict({
        "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 9,
        "base_resolution": 4, "per_level_scale": 2.0}, **options), n_dims)
    g = torch.Generator().manual_seed(n_dims)
    table = (torch.rand((cfg.total_params, 2), generator=g) - 0.5).requires_grad_(True)
    return cfg, table, torch.rand((m, n_dims), generator=g)


@pytest.mark.parametrize("options,n_dims,mode", [
    ({"hashed_tile": "on"}, 3, "xla_bf16"),  # the pair-bucket grid: the bf16 table
    ({"fwd_mode": "xla"}, 3, "xla"),
    ({"fwd_mode": "xla"}, 2, "xla"),
    ({}, 4, "xla_bf16"),  # a 4-D grid: no kernel takes it
], ids=["pair_bucket", "xla 3-D", "xla 2-D", "bf16 4-D"])
def test_the_exact_gather_opens_the_kernel_paths_spans(options, n_dims, mode):
    """The exact path opens the spans the kernel path opens, with its
    counts: ``hash_encode.fwd`` (points), inside it ``hash_encode.prepare``
    (table rows) where the table is rounded to bf16, and under autograd
    ``hash_encode.bwd`` (points) inside the caller's backward; a forward
    with no graph opens no ``bwd``. Each call adds one to
    ``hash_encode_exact.calls[(mode, D)]`` and to no other key."""
    from atmonr_tpu_torch.models import hash_grid as hg

    cfg, table, x = _exact_case(options, n_dims)
    assert hg.resolve_fwd_mode(cfg) == mode
    before = dict(hg.hash_encode_exact.calls)
    with spans.recording() as records:
        with spans.span("caller.forward"):
            out = hg.hash_encode(table, x, cfg)
        with spans.span("caller.backward"):
            out.sum().backward()
        with torch.no_grad(), spans.span("caller.query"):
            hg.hash_encode(table, x[:7], cfg)
    of, by = {r.id: r for r in records}, _by_name(records)
    assert [(of[r.parent].name, r.count) for r in by["hash_encode.fwd"]] == [
        ("caller.forward", 300), ("caller.query", 7)]
    assert [(of[r.parent].name, r.count) for r in by["hash_encode.bwd"]] == [
        ("caller.backward", 300)]
    prepared = [(of[r.parent].name, r.count) for r in by.get("hash_encode.prepare", [])]
    assert prepared == ([("hash_encode.fwd", cfg.total_params)] * 2 if mode == "xla_bf16" else [])
    moved = {k: v - before.get(k, 0) for k, v in hg.hash_encode_exact.calls.items()
             if v != before.get(k, 0)}
    assert moved == {(mode, n_dims): 2}


def test_the_exact_gather_records_nothing_when_off(monkeypatch):
    """Outside ``recording()`` the exact path's spans are the shared
    no-op, and its output and gradient are the same as with them on (on
    one thread: the CPU's threaded index backward sums duplicate rows in a
    varying order)."""
    from _torch_threads import one_torch_thread
    from atmonr_tpu_torch.models import hash_grid as hg

    cfg, table, x = _exact_case({"hashed_tile": "on"}, 3)
    returned, real = [], spans.span

    def watching(*args, **kwargs):
        returned.append(real(*args, **kwargs))
        return returned[-1]

    monkeypatch.setattr(spans, "span", watching)
    with one_torch_thread():
        out = hg.hash_encode(table, x, cfg)
        out.sum().backward()
        off = (out.detach(), table.grad.clone())
        assert len(returned) == 3 and all(r is spans._NO_SPAN for r in returned)
        table.grad = None
        with spans.recording():
            out = hg.hash_encode(table, x, cfg)
            out.sum().backward()
    assert torch.equal(off[0], out.detach()) and torch.equal(off[1], table.grad)
