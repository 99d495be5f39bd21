"""The pair-bucket train cell ``occ21pb.train.real`` on the CPU: its runner
(``perfbench/runners/train_pb.py``) at a tiny cut against its reference
(``perfbench/reference/ngp_pb.py``), the planted fault ``hash:plain``
caught; the ``encode_*.pb`` readers on a synthetic device trace, and
silent without the exact path's spans; ``perfbench/work_pb.py``'s counts
at the published size."""

import json

import pytest
import torch

from _perfbench_tiny import CPU_TOLERANCE, ROOT
from perfbench import harness, spec, work, work_pb
from perfbench.span_trace import SpanTrace

CELL = "occ21pb.train.real"
READERS = ("encode_fwd_ms.pb", "encode_bwd_ms.pb", "encode_roofline.pb")


def _config() -> dict:
    return json.loads((ROOT / "perfbench/configs/ngp_occ21_pb.json").read_text())


def _tiny_cell() -> spec.Cell:
    """The cell with both grids at 2^12 rows a level and 256 rays a step."""
    cell = spec.load_cell(ROOT, CELL)
    ngp = cell.config["pipeline"]["instant_ngp"]
    ngp["encoding"]["log2_hashmap_size"] = 12
    ngp["surface_encoding"]["nested"][0]["log2_hashmap_size"] = 10
    cell.config["trainer"]["batch_size"] = 256
    cell.traffic["granule"] = {"kind": "real_schema", "height": 16, "width": 12}
    cell.traffic.update(warmup_max_steps=16, trace_steps=4)
    return cell


@pytest.fixture(scope="module")
def tiny():
    import time

    run, _ = harness.run_cell(ROOT, CELL, 2**33 + 17, 0.5, True, torch.device("cpu"),
                              time.perf_counter(), _tiny_cell(), ("hash:plain",))
    return run


def test_the_runner_agrees_with_the_reference_on_the_cpu(tiny):
    readings = {k: tiny.readings[k] for k in spec.load_cell(ROOT, CELL).limits}
    assert all(readings[k] <= CPU_TOLERANCE[k] for k in readings), readings
    assert tiny.failed == 0 and tiny.work["refreshes"] >= 0


def test_the_plain_hash_is_caught(tiny):
    """The reference with the ordinary spatial hash in the pair-bucket's
    place reads the loss and the refreshed grid far above the program's
    own gaps and the CPU's tolerance."""
    plain = tiny.readings["hash:plain"]
    for k in ("loss_gap", "occ_gap"):
        assert plain[k] > max(CPU_TOLERANCE[k], 10 * tiny.readings[k]), (k, plain)


def test_the_traced_steps_count_every_encoded_point_in_the_spans(tiny):
    """The profiled steps' spans count the points of both grids' encodes
    and backwards, as ``work.train_work`` counts them."""
    assert tiny.span_counts["hash_encode.fwd"] == work_pb.encoded_points(tiny.traced, False)
    assert tiny.span_counts["hash_encode.bwd"] == work_pb.encoded_points(tiny.traced, True)


def test_work_pb_counts_the_published_table():
    """21,141,696 position rows; one forward of a step's 196,608 points
    reads the float32 table (8 B a row), the points, writes the features,
    and of each level reads at most 8 bf16 rows a point: the 7 dense levels
    whole (2,267,328 rows), 1,572,864 of each of the 9 hashed ones."""
    grids = work_pb.grids(_config()["pipeline"])
    pos = grids[3]
    assert pos.rows == 21_141_696 and sum(pos.sizes[:7]) == 2_267_328
    m = 196_608
    assert work_pb.encode_bytes(pos, m, False) == (
        21_141_696 * 8 + m * 12 + m * 128 + 4 * (2_267_328 + 9 * 8 * m))
    assert work_pb.encode_bytes(pos, m, True) == (
        m * 128 + 21_141_696 * 8 + 8 * (2_267_328 + 9 * 8 * m))


def _traced_run(spans_open: bool = True, counts: dict | None = None):
    """A traced run of the cell as the readers see it: 16 profiled steps
    with one refresh, and a trace with three launches inside an encode's
    spans (10, 20 and 30 us, the 20 inside ``hash_encode.prepare``), one
    inside a backward's on another thread (40 us), one outside (1 ms)."""
    events, corr = [], 0

    def launch(tid, ts, us):
        nonlocal corr
        corr += 1
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": ts, "dur": 1.0, "tid": tid, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": 1000.0 + ts,
                       "dur": us, "tid": 7, "args": {"correlation": corr}})

    if spans_open:
        for tid, name, ts, dur in ((1, "hash_encode.fwd", 0.0, 100.0),
                                   (1, "hash_encode.prepare", 10.0, 20.0),
                                   (2, "hash_encode.bwd", 200.0, 100.0)):
            events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                           "dur": dur, "tid": tid, "args": {}})
    for tid, ts, us in ((1, 5.0, 10.0), (1, 15.0, 20.0), (1, 50.0, 30.0), (2, 210.0, 40.0),
                        (1, 400.0, 1000.0)):
        launch(tid, ts, us)
    config = _config()
    traced = work.train_work(config["pipeline"], 8192, 16, 1)
    if counts is None:
        counts = {"hash_encode.fwd": work_pb.encoded_points(traced, False),
                  "hash_encode.bwd": work_pb.encoded_points(traced, True)}
    from types import SimpleNamespace

    return SimpleNamespace(trace=SpanTrace(events, 1.0), traced=traced, config=config,
                           span_counts=counts)


def test_the_encode_readers_read_the_spans_device_time():
    """Device ms a step inside each span, and the least time of the steps'
    encodes over the device time inside both."""
    run = _traced_run()
    read = {name: spec.metric_reader(name, ROOT)(run) for name in READERS}
    assert read["encode_fwd_ms.pb"] == pytest.approx(60e-3 / 16)
    assert read["encode_bwd_ms.pb"] == pytest.approx(40e-3 / 16)
    least = work_pb.least_seconds(run.config["pipeline"], run.traced)
    assert read["encode_roofline.pb"] == pytest.approx(100.0 * least / 100e-6)
    # a step's least traffic is ~0.6 GB: 16 steps and a refresh at 3.35 TB/s
    assert 2.5e-3 < least < 3.5e-3


@pytest.mark.parametrize("case", ["no spans", "surface only", "no trace"])
def test_the_encode_readers_read_nothing_without_the_exact_paths_spans(case):
    """No ``hash_encode`` span in the trace; spans that count the surface
    grid's points alone (a program whose exact gather opens none); no
    trace: each reader gives None and raises nothing."""
    if case == "no spans":
        run = _traced_run(spans_open=False)
    elif case == "surface only":
        run = _traced_run(counts={"hash_encode.fwd": 16 * 8192, "hash_encode.bwd": 16 * 8192})
    else:
        run = _traced_run()
        run.trace = None
    assert all(spec.metric_reader(name, ROOT)(run) is None for name in READERS)
