"""The port's Instant-NGP extraction at the upstream's published widths
against the benchmark's plain reference (``perfbench/reference/ngp.py``),
on the CPU at a small size: ``configs/instant_ngp_occ21.json`` (16 levels
of 2 features, growth 1.3819, 32-wide MLPs, ``fwd_mode`` auto: bfloat16
tables) with both hash tables cut from 2^21 and 2^19 rows a level to 2^14,
where every level past the second hashes (9 of 16 at 2^21), over the L1C
grid of an 8 x 6-pixel swath at a 250 m ladder (3,888 points) in
1,024-point batches, with the benchmark's seeded parameters
(``perfbench/inputs.py``).

The port runs its entry points (``get_extract_dataset("l1c")``,
``run_extraction``); the reference builds the grid's points and computes
their extinction itself (its geodesy, preprocessor, hash encoding over the
bfloat16-rounded table, bfloat16 MLP products). It is given the port's
normalisation box: on the CPU its own ray build and the port's host
library round an origin apart in the last float32 bit, which moves the box
by an eighth of a metre, every point's normalised coordinates with it, and
through the bfloat16 products a point's sigma by up to 2% of the largest.

Compared as the benchmark compares ``occ21.extract.l1c``: the grid's
points to the cell's ``grid_gap_m``, sigma to its ``sigma_gap``. On the
same points both sides compute the same float32 interpolation and the same
bfloat16 products in the same order, so sigma agrees to the bit here; the
cell's limit, set from the card's readings and a tenth of the least
lower-precision control, is the tolerance, and a reference that keeps the
table in float8 (e4m3) or int8 codes fails it."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread
from atmonr_tpu_torch import get_extract_dataset, get_pipeline, run_extraction
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.ops.hash_gather import prepare_table
from atmonr_tpu_torch.utils import spans
from perfbench import inputs
from perfbench.reference import geo, ngp, scene
from perfbench.runners.extract import compare, reference_sigma
from perfbench.runners.train import _granule_arrays

REPO = Path(__file__).resolve().parent.parent
SEEDS = (2**33 + 29, 2**31 + 7)
LOG2_ROWS = 14  # a level's rows on the CPU (published: 2^21 position, 2^19 surface)
SWATH = {"kind": "swath", "height": 8, "width": 6, "views_per_band": 2}
ALT_STEP = 250.0
BATCH = 1024
LIMITS = json.loads((REPO / "perfbench/workloads/occ21.extract.l1c.json").read_text())["limits"]


def _config() -> dict:
    config = json.loads((REPO / "perfbench/configs/ngp_occ21.json").read_text())
    ngp_cfg = config["pipeline"]["instant_ngp"]
    ngp_cfg["encoding"]["log2_hashmap_size"] = LOG2_ROWS
    ngp_cfg["surface_encoding"]["nested"][0]["log2_hashmap_size"] = LOG2_ROWS
    return config


@pytest.fixture(scope="module", params=SEEDS, ids=["seed_a", "seed_b"])
def extraction(request):
    """The port's extraction of one seed's grid, the reference's grid and
    its inputs, and the spans and preparation count of the port's query."""
    seed, config = request.param, _config()
    params_spec = json.loads((REPO / "perfbench/traffic/extract.l1c.json").read_text())["params"]
    cpu = torch.device("cpu")
    with one_torch_thread():
        granule = inputs.make_granule(SWATH, seed)
        ds = HARP2Dataset(config["dataset"], _granule_arrays(granule), device=cpu)
        params = inputs.make_params(config["pipeline"], params_spec, seed, cpu)
        pipe = get_pipeline(config["pipeline"], ds, device=cpu)
        pipe.load_params(params)
        grid = get_extract_dataset("l1c", ds, alt_step=ALT_STEP)
        before = dict(prepare_table.calls)
        with spans.recording() as records:
            sigma = run_extraction(pipe, grid, batch_size=BATCH)
        prepared = {k: v - before[k] for k, v in prepare_table.calls.items() if v != before[k]}
        sc = scene.build_scene(granule, config["dataset"], cpu)
        sc = dataclasses.replace(sc, scale=ds.scale, offset=np.asarray(ds.offset))
        ref_xyz = geo.l1c_points(sc.lat, sc.lon, sc.alt, sc.image_shape, ALT_STEP,
                                 sc.origin_height)
        ref = reference_sigma(config, sc, params, ref_xyz, BATCH)
    return {"config": config, "sc": sc, "params": params, "xyz": np.array(grid.xyz),
            "sigma": sigma, "ref_xyz": ref_xyz, "ref": ref, "records": list(records),
            "prepared": prepared, "rows": pipe.pos_cfg.total_params}


def test_the_cut_keeps_the_published_widths():
    """Only the rows a level change: 16 levels of 2 features at growth
    1.3819 from 16, bfloat16 tables, 32-wide MLPs; the published file has
    21,141,696 position rows, 169.1 MB in float32."""
    published = json.loads((REPO / "configs/instant_ngp_occ21.json").read_text())["pipeline"]
    cut = _config()["pipeline"]
    for pipeline in (published, cut):
        pos = ngp.Grid.of(pipeline["instant_ngp"]["encoding"], 3)
        assert (pos.levels, pos.features, pos.base, pos.growth, pos.stored) == (
            16, 2, 16, 1.3819, "bf16")
        shapes = ngp.param_shapes(pipeline)
        assert shapes["pos_mlp.layers.0.weight"] == (32, 32)
        assert shapes["pos_mlp.layers.2.weight"] == (16, 32)
    assert ngp.param_shapes(published)["pos_table"] == (21_141_696, 2)
    pos = ngp.Grid.of(cut["instant_ngp"]["encoding"], 3)
    hashed = [pos.resolution(level) ** 3 > (1 << LOG2_ROWS) for level in range(pos.levels)]
    assert hashed == [False] * 2 + [True] * 14


def test_the_extraction_matches_the_reference(extraction):
    """The grid's points within ``grid_gap_m`` metres, sigma within
    ``sigma_gap`` of the reference's largest, over a field with structure."""
    e = extraction
    got = compare(e["xyz"], e["sigma"], e["ref_xyz"], e["ref"])
    assert e["sigma"].shape == (3888, 1) and (e["ref"] > 0).mean() > 0.5
    assert got["grid_gap_m"] <= LIMITS["grid_gap_m"], got
    assert got["sigma_gap"] <= LIMITS["sigma_gap"], got


@pytest.mark.parametrize("fmt", ["e4m3", "q8"])
def test_a_lower_precision_table_fails_the_tolerance(extraction, fmt):
    """The reference with its position table kept as float8 or int8 codes
    in the program's place reads a sigma gap above the limit."""
    e = extraction
    control = reference_sigma(e["config"], e["sc"], e["params"], e["ref_xyz"], BATCH, fmt)
    got = compare(e["ref_xyz"], control[:, None], e["ref_xyz"], e["ref"])
    assert got["sigma_gap"] > LIMITS["sigma_gap"], got


def test_each_batch_prepares_the_table_once(extraction):
    """One preparation a batch, counted in ``prepare_table.calls``, and one
    ``hash_encode.prepare`` span inside each batch's ``hash_encode.fwd``,
    its count the table's rows."""
    e = extraction
    batches = -(-3888 // BATCH)
    assert e["prepared"] == {("bf16", 3): batches}
    by_id = {r.id: r for r in e["records"]}
    prep = [r for r in e["records"] if r.name == "hash_encode.prepare"]
    assert len(prep) == batches and all(r.count == e["rows"] for r in prep)
    assert all(by_id[r.parent].name == "hash_encode.fwd" for r in prep)


def _traced_run(kernels: list[tuple[str, float]], extractions: int = 2):
    """A traced run of ``occ21.extract.l1c`` as the metric readers see it:
    the published configuration, ``extractions`` profiled extractions of
    the cell's 6,561,792 points in 32,768-point batches, and a device trace
    of the given (kernel name, microseconds) launches."""
    from types import SimpleNamespace

    from perfbench import work
    from perfbench.trace import Trace

    events, ts = [], 0.0
    for name, us in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": us, "args": {}})
        ts += us + 1.0
    config = json.loads((REPO / "perfbench/configs/ngp_occ21.json").read_text())
    return SimpleNamespace(trace=Trace(events, 1.0), config=config,
                           traced=work.query_work(config["pipeline"], 6_561_792, 32_768,
                                                  extractions))


def test_the_table_readers_count_the_published_table():
    """The three ``.extract21`` readers against counts worked out by hand:
    a preparation reads the 21,141,696 x 2 float32 table (169.1 MB, 50.49
    us at 3.35 TB/s); a 32,768-point gather reads the points, writes the
    features and reads at most 8 rows of 4 bytes a point of each level."""
    from perfbench import spec, work_table

    pipeline = json.loads((REPO / "perfbench/configs/ngp_occ21.json").read_text())["pipeline"]
    assert work_table.prep_least_seconds(pipeline) == 21_141_696 * 8 / 3.35e12
    sizes = ngp.Grid.of(pipeline["instant_ngp"]["encoding"], 3).sizes
    table = sum(min(8 * 32_768, s) for s in sizes) * 4
    assert table == (4096 + 12168 + 29792 + 79512 + 205384 + 11 * 262_144) * 4
    assert work_table.gather_least_seconds(pipeline, 32_768) == (
        32_768 * 12 + 32_768 * 128 + table) / 3.35e12
    batches = 2 * 201  # 200 full batches and a tail of 8,192 points an extraction
    prep, gather = "round_bf16_kernel(float4 const*, uint4*, long long)", "hash_gather_direct<1>"
    run = _traced_run([(prep, 80.0)] * batches + [(gather, 40.0)] * batches
                      + [("void at::native::vectorized_elementwise_kernel<4>", 5.0)] * batches)
    prep_ms = spec.metric_reader("table_prep_ms.extract21", REPO)(run)
    assert prep_ms == pytest.approx(201 * 80.0 / 1e3)
    share = spec.metric_reader("table_prep_roofline.extract21", REPO)(run)
    assert share == pytest.approx(100.0 * 50.4876 / 80.0, rel=1e-5)
    gather = spec.metric_reader("gather_roofline.extract21", REPO)(run)
    least = 2 * (200 * work_table.gather_least_seconds(pipeline, 32_768)
                 + work_table.gather_least_seconds(pipeline, 8192))
    assert gather == pytest.approx(100.0 * least / (batches * 40e-6))


def test_the_table_readers_read_nothing_without_the_kernel():
    """A trace with no ``round_bf16_kernel`` (the table rounded by ATen's
    cast, as before this kernel) gives no preparation metric, and raises
    nothing; a run without a trace gives none of the three."""
    from perfbench import spec

    run = _traced_run([("void at::native::unrolled_elementwise_kernel<direct_copy>", 90.0),
                       ("void (anonymous namespace)::hash_gather_direct_kernel<1>", 40.0)])
    names = ("table_prep_ms.extract21", "table_prep_roofline.extract21",
             "gather_roofline.extract21")
    assert [spec.metric_reader(n, REPO)(run) is None for n in names] == [True, True, False]
    run.trace = None
    assert all(spec.metric_reader(n, REPO)(run) is None for n in names)
