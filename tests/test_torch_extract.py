"""The port's extraction against the JAX package's, on the CPU: the voxel
traversal, the four grids built by each package from its own dataset of
the same synthetic granule, the batched query over them with the
parameters carried across, the writers' files, the checkpoint restore and
the extract CLI's refusals.

Grids are host numpy float64 in both packages, so they must be equal bit
for bit. The query runs the flagship's structure at small widths
(``test_torch_pipeline._config``) in both packages with one shared float64
preprocessor; JAX runs it under jit, where XLA turns the division by the
scene scale into a product with its reciprocal: rtol 1e-5.
"""

import dataclasses
import sys
import warnings
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_native import jax_native_library  # noqa: F401  (an autouse fixture)
from _torch_points import ecef_points, midpoint_points
from atmonr_tpu.data.synthetic import (
    write_granule_l1c,
    write_synthetic_dem,
    write_synthetic_earthcare,
)
from atmonr_tpu.extract import datasets as jdatasets
from atmonr_tpu.extract import get_extract_dataset as jax_get_extract_dataset
from atmonr_tpu.extract.runner import run_extraction as jax_run_extraction
from atmonr_tpu.extract.voxel_traversal import voxel_traversal as jax_voxel_traversal
from atmonr_tpu.models import hash_grid as jhg
from atmonr_tpu.pipelines.instant_ngp import InstantNGPPipeline as JaxPipeline
from atmonr_tpu_torch import convert, get_extract_dataset, get_pipeline, native, run_extraction
from atmonr_tpu_torch.extract import datasets as tdatasets
from atmonr_tpu_torch.extract.voxel_traversal import voxel_traversal
from atmonr_tpu_torch.scripts import extract as extract_cli
from atmonr_tpu_torch.training import checkpoint as tckpt
from test_torch_pipeline import (
    _config,
    _jax_dataset,
    _port_dataset,
    _q8_dispatch,
    _share_preprocessor,
)

REPO = Path(__file__).resolve().parent.parent
GLOBAL_SCALE = 100 / 6.378e6
REAL_NAME = "PACE_HARP2.20240321T114400.L1B.V3.nc"  # an L1B name with a matching L1C


@pytest.fixture(scope="module")
def datasets():
    """(JAX dataset, port dataset) of one synthetic granule; their host
    arrays are equal (``test_torch_pipeline``)."""
    config = _config("xla")
    return _jax_dataset(config), _port_dataset(config["dataset"])


def _rows(a) -> set:
    return set(map(tuple, np.asarray(a).tolist()))


# -- voxel traversal ---------------------------------------------------------


@pytest.mark.parametrize("unique_only", [True, False], ids=["unique", "all"])
@pytest.mark.parametrize("dims", [2, 3])
def test_voxel_traversal_matches_jax(dims, unique_only):
    """200 random segments (the JAX package walks 3-D ones natively where
    its library is built): the same voxels, as sets; unique rows equal and
    sorted."""
    rng = np.random.default_rng(dims)
    u = rng.uniform(-6, 6, (200, dims))
    end = rng.uniform(-6, 6, (200, dims))
    end[:5] = u[:5]  # zero-length segments
    end[5:10, 0] = u[5:10, 0]  # segments parallel to an axis plane
    got = voxel_traversal(u, end, unique_only=unique_only)
    want = jax_voxel_traversal(u, end, unique_only=unique_only)
    assert got.dtype == np.int32 and got.shape[1] == dims
    assert _rows(got) == _rows(want)
    if unique_only:
        np.testing.assert_array_equal(got, want)


def test_voxel_traversal_straight_line():
    vox = voxel_traversal(np.array([[0.5, 0.5]]), np.array([[4.5, 0.5]]))
    assert _rows(vox) == {(0, 0), (1, 0), (2, 0), (3, 0), (4, 0)}


# -- grids -----------------------------------------------------------------------


def _same_grid(got, want, fields) -> None:
    assert type(got).__name__ == type(want).__name__
    assert got.shp == want.shp and len(got) == len(want) > 0
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.idx, want.idx)
    for name in fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("alt", [(2000.0, None, None), (500.0, 1000.0, 6000.0)],
                         ids=["ladder", "min-max"])
def test_pseudo_l1c_grid_matches_jax(datasets, alt):
    jds, tds = datasets
    step, lo, hi = alt
    kw = dict(alt_step=step, min_alt=lo, max_alt=hi)
    got, want = get_extract_dataset("l1c", tds, **kw), jax_get_extract_dataset("l1c", jds, **kw)
    _same_grid(got, want, ("lat", "lon", "height", "sample_alt"))


@pytest.mark.parametrize("alt", [(2000.0, None, None), (500.0, 1000.0, 6000.0)],
                         ids=["ladder", "min-max"])
def test_l1c_grid_points_and_views(datasets, alt):
    """The grid's points are one C-contiguous float64 (N, 3) array; ``lat``
    / ``lon`` are read-only (H, W, na) views of the pixels, in their dtype,
    equal to the pixels repeated over the ladder."""
    _, tds = datasets
    step, lo, hi = alt
    grid = get_extract_dataset("l1c", tds, alt_step=step, min_alt=lo, max_alt=hi)
    h, w = tds.img_shp[0], tds.img_shp[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pix = [np.nan_to_num(np.nanmean(a.reshape(h, w, -1), axis=-1)) for a in (tds.lat, tds.lon)]
    na = grid.sample_alt.shape[0]
    assert grid.shp == (h, w, na) and len(grid) == h * w * na
    rep = [np.repeat(p[:, :, None], na, axis=2) for p in pix]
    for got, want in zip((grid.lat, grid.lon), rep):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert not got.flags.writeable
        np.testing.assert_array_equal(got, want)
    assert grid.xyz.shape == (len(grid), 3) and grid.xyz.dtype == np.float64
    assert grid.xyz.flags.c_contiguous


def _with_product_name(ds, name):
    return dataclasses.replace(ds.granule, product_name=name)


def test_l1c_product_grid_matches_jax(datasets, tmp_path, monkeypatch):
    """A granule with a real product name reads its L1C product (north up,
    fill values as NaN, then 0) from ``<data_root>/HARP2_L1C/``."""
    jds, tds = datasets
    path = tmp_path / "HARP2_L1C" / "PACE_HARP2.20240321T114400.L1C.V3.5km.nc"
    write_granule_l1c(path, height=12, width=7)
    with h5py.File(path, "r+") as f:
        f["geolocation_data/height"][3, 2] = -32767.0
    for ds in (jds, tds):
        monkeypatch.setattr(ds, "granule", _with_product_name(ds, REAL_NAME))
    kw = dict(alt_step=4000.0, data_root=tmp_path)
    got, want = get_extract_dataset("l1c", tds, **kw), jax_get_extract_dataset("l1c", jds, **kw)
    assert got.shp == (12, 7, 6) and got.height[-4, 2] == 0.0
    _same_grid(got, want, ("lat", "lon", "height", "sample_alt"))


def test_missing_l1c_product_raises(datasets, tmp_path, monkeypatch):
    """Earthdata downloads are not ported: the missing file is named."""
    _, tds = datasets
    monkeypatch.setattr(tds, "granule", _with_product_name(tds, REAL_NAME))
    with pytest.raises(FileNotFoundError, match="PACE_HARP2.20240321T114400.L1C.V3.5km.nc"):
        get_extract_dataset("l1c", tds, alt_step=4000.0, data_root=tmp_path)


def _dem(tmp_path) -> Path:
    """An ETOPO1-layout DEM over the synthetic swath (as the JAX package's
    ``tests/test_extract.py`` writes one), with water over some of it."""
    rows = np.arange(32)[:, None] * np.ones((1, 44))
    height = 100.0 + 50.0 * np.sin(rows / 3.0)
    height[:, :5] = -200.0
    path = tmp_path / "ETOPO1_ocssw.nc"
    write_synthetic_dem(path, height, water_surface_height=np.where(height < 0, 0.0, -500.0),
                        upper_lat=22.0, left_lon=-42.0, lat_res=0.1, lon_res=0.1)
    return path


@pytest.mark.parametrize("steps", [(3000.0, 5000.0), (1500.0, 2500.0)], ids=["3km", "1.5km"])
def test_voxelgrid_matches_jax(datasets, tmp_path, steps):
    jds, tds = datasets
    kw = dict(horizontal_step=steps[0], alt_step=steps[1], dem_path=_dem(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the DEM is read, no fallback
        got = get_extract_dataset("voxelgrid", tds, **kw)
        want = jax_get_extract_dataset("voxelgrid", jds, **kw)
    assert got.height.min() > 40.0
    _same_grid(got, want, ("lat", "lon", "height", "sample_alt"))


def test_voxelgrid_without_dem_has_zero_heights(datasets, tmp_path):
    jds, tds = datasets
    kw = dict(horizontal_step=3000.0, alt_step=5000.0, dem_path=tmp_path / "none.nc")
    with pytest.warns(UserWarning, match="using zero surface heights"):
        got = get_extract_dataset("voxelgrid", tds, **kw)
    with pytest.warns(UserWarning, match="using zero surface heights"):
        want = jax_get_extract_dataset("voxelgrid", jds, **kw)
    assert (got.height == 0).all()
    _same_grid(got, want, ("lat", "lon", "height", "sample_alt"))


@pytest.mark.parametrize("mode", ["l1c", "voxelgrid"])
def test_regional_grid_points_come_from_the_host_library(datasets, tmp_path, mode):
    """The regional grids expand their pixels over the ladder in the host
    library: its counter moves by the grid's points (the voxelgrid without
    a DEM file, as above)."""
    _, tds = datasets
    kw = dict(alt_step=2000.0)
    if mode == "voxelgrid":
        kw = dict(horizontal_step=3000.0, alt_step=5000.0, dem_path=tmp_path / "none.nc")
    before = native.horizontal_grid_to_cartesian.points
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the voxelgrid's zero surface heights
        grid = get_extract_dataset(mode, tds, **kw)
    assert len(grid) > 0
    assert native.horizontal_grid_to_cartesian.points - before == len(grid)


def test_interp_dem_height_matches_jax(tmp_path):
    """Bilinear heights at random points, some off the DEM's edges."""
    path = _dem(tmp_path)
    rng = np.random.default_rng(5)
    lat, lon = rng.uniform(18.5, 22.5, (9, 11)), rng.uniform(-42.5, -37.0, (9, 11))
    got = tdatasets.interp_dem_height(path, lat, lon)
    np.testing.assert_array_equal(got, jdatasets.interp_dem_height(path, lat, lon))
    assert got.shape == (9, 11) and got.min() >= 0


def test_geodesic_grid_matches_jax(datasets):
    jds, _ = datasets
    shape = list(jds.img_shp) + [jds.view_idx.shape[0]]
    corners = jdatasets.swath_corner_latlons(jds.lat.reshape(shape), jds.lon.reshape(shape))
    np.testing.assert_array_equal(
        tdatasets.swath_corner_latlons(jds.lat.reshape(shape), jds.lon.reshape(shape)), corners)
    for step in (800.0, 2500.0):
        got, want = tdatasets.geodesic_grid(corners, step), jdatasets.geodesic_grid(corners, step)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grid", [(0.01, 12.0, 0.05), (0.02, 4.0, 0.1), (0.05, None, 0.0)],
                         ids=["0.01", "0.02-crop", "0.05-nostretch"])
def test_global_grid_matches_jax(datasets, grid):
    """Voxels, points and their order (the port merges int64 keys and
    crops the layers in one pass; the JAX package sorts float rows)."""
    jds, tds = datasets
    res, vstretch, crop = grid
    kw = dict(scale=GLOBAL_SCALE, grid_res=res, vstretch=vstretch, lon_crop=crop)
    got = get_extract_dataset("globalgrid", tds, **kw)
    want = jax_get_extract_dataset("globalgrid", jds, **kw)
    assert got.voxels.dtype == np.int32
    _same_grid(got, want, ("voxels",))


def test_global_grid_merges_chunks(datasets, monkeypatch):
    """Rays traversed in several chunks give the grid of one chunk."""
    _, tds = datasets
    kw = dict(scale=GLOBAL_SCALE, grid_res=0.02, vstretch=12.0)
    whole = get_extract_dataset("globalgrid", tds, **kw)
    monkeypatch.setattr(tdatasets, "_CHUNK_SIZE", 37)
    chunked = get_extract_dataset("globalgrid", tds, **kw)
    _same_grid(chunked, whole, ("voxels",))


@pytest.mark.parametrize("rng", [None, [5, 30]], ids=["track", "range"])
def test_earthcare_grid_matches_jax(datasets, tmp_path, rng):
    jds, tds = datasets
    write_synthetic_earthcare(tmp_path / "EarthCARE" / "track.h5")
    kw = dict(earthcare_filename="track.h5", earthcare_range=rng, data_root=tmp_path)
    got = get_extract_dataset("earthcare", tds, **kw)
    want = jax_get_extract_dataset("earthcare", jds, **kw)
    assert got.shp[0] == (25 if rng else 40)
    _same_grid(got, want, ("lat", "lon", "alt"))
    assert got._h5_attrs == want._h5_attrs


# -- the batched query -----------------------------------------------------------


@pytest.fixture(scope="module", params=["xla", "q8"])
def pipelines(request, datasets):
    """The JAX pipeline and the port's with the same parameters, float32
    MLP products and one shared float64 preprocessor."""
    jds, tds = datasets
    config = _config(request.param)
    jpipe = JaxPipeline(config["pipeline"], jds)
    jpipe.compute_dtype = jnp.float32
    params = jpipe.init_params(jax.random.PRNGKey(7))
    tpipe = get_pipeline(config["pipeline"], tds, device="cpu")
    tpipe.compute_dtype = torch.float32
    tpipe.load_params(convert.params_from_jax(params))
    _share_preprocessor(jpipe, tpipe, jds.scene_transform)
    return request.param, jpipe, params, tpipe


@pytest.mark.parametrize("mode", ["l1c", "globalgrid"])
def test_run_extraction_matches_jax(datasets, pipelines, mode, monkeypatch):
    """Sigma over a whole grid (batches of 512 and a tail): rtol 1e-5 plus
    1e-6 of the largest value. q8 runs the Pallas q8 kernel in interpret
    mode in JAX."""
    jds, tds = datasets
    fwd_mode, jpipe, params, tpipe = pipelines
    if fwd_mode == "q8":
        monkeypatch.setattr(jhg, "_fwd_dispatch", _q8_dispatch)
    kw = (dict(alt_step=2000.0) if mode == "l1c"
          else dict(scale=GLOBAL_SCALE, grid_res=0.05, vstretch=12.0))
    tgrid = get_extract_dataset(mode, tds, **kw)
    want = jax_run_extraction(jpipe, params, jax_get_extract_dataset(mode, jds, **kw),
                              batch_size=512)
    got = run_extraction(tpipe, tgrid, batch_size=512)
    assert got.shape == want.shape == (len(tgrid), 1) and got.dtype == np.float32
    assert len(tgrid) % 512 and np.all(np.isfinite(got)) and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_run_extraction_verbose_counts_batches(datasets, capsys):
    _, tds = datasets
    tpipe = get_pipeline(_config("xla")["pipeline"], tds, device="cpu")
    pts = get_extract_dataset("l1c", tds, alt_step=2000.0)
    quiet = run_extraction(tpipe, pts, batch_size=500)
    assert capsys.readouterr().out == ""
    np.testing.assert_array_equal(run_extraction(tpipe, pts, batch_size=500, verbose=True), quiet)
    out = capsys.readouterr().out
    assert "extract batch 3/3" in out and out.endswith("\n")


def _extraction_counters() -> tuple[int, int, int]:
    return (run_extraction.graph_batches, run_extraction.eager_batches, run_extraction.captures)


def test_run_extraction_is_eager_on_the_cpu(datasets):
    """On the CPU every batch, full or tail, runs eagerly: no graph is
    captured or replayed."""
    _, tds = datasets
    tpipe = get_pipeline(_config("q8")["pipeline"], tds, device="cpu")
    grid = get_extract_dataset("l1c", tds, alt_step=2000.0)
    before = _extraction_counters()
    run_extraction(tpipe, grid, batch_size=500)
    run_extraction(tpipe, grid, batch_size=500)
    graphed, eager, captures = (a - b for a, b in zip(_extraction_counters(), before))
    assert (graphed, eager, captures) == (0, 2 * -(-len(grid) // 500), 0)


def test_run_extraction_writes_each_batch_into_one_sigma(datasets):
    """Sigma over a grid with a tail is, bit for bit, ``pipeline.extract``
    of each batch over ``scale``, in batch order."""
    _, tds = datasets
    tpipe = get_pipeline(_config("q8")["pipeline"], tds, device="cpu")
    grid = get_extract_dataset("l1c", tds, alt_step=2000.0)
    got = run_extraction(tpipe, grid, batch_size=500)
    pts = torch.from_numpy(((grid.xyz - np.asarray(tpipe.offset)[None]) / tpipe.scale)
                           .astype(np.float32))
    want = torch.cat([tpipe.extract(pts[i:i + 500]) / tpipe.scale
                      for i in range(0, len(pts), 500)]).numpy()
    assert len(grid) % 500 and got.shape == want.shape == (len(grid), 1)
    np.testing.assert_array_equal(got, want)


class _PointsSeen:
    """A pipeline stand-in on the CPU whose ``extract`` keeps the
    normalized points of each batch."""

    def __init__(self, scale: float, offset: np.ndarray):
        self.scale, self.offset, self.device = scale, offset, "cpu"
        self.batches = []

    def extract(self, pts: torch.Tensor) -> torch.Tensor:
        self.batches.append(pts.clone())
        return pts.new_ones((pts.shape[0], 1))


class _OneRankOf:
    """The part of a (data, sample) device mesh that ``run_extraction``
    reads: its shape and this rank's coordinate."""

    def __init__(self, shape: tuple[int, int], coord: tuple[int, int]):
        self.mesh, self.coord = torch.zeros(shape), coord

    def get_coordinate(self):
        return self.coord


def test_batches_are_normalized_as_the_host_normalized_the_whole_grid(monkeypatch):
    """Earth-scale ECEF points: ``normalize`` over 2 M of them, and 200,000
    whose normalized coordinates sit at float32 midpoints, equals
    ``((xyz - offset) / scale).astype(np.float32)`` bit for bit (a product
    with the reciprocal of the scale does not, on the midpoints); so do the
    points each batch of ``run_extraction`` hands to ``pipeline.extract``:
    full batches and a tail, and with a mesh of four ranks each rank's rows
    of each batch, the tail's last ranks padded with zero rows (one rank
    gets no row of it)."""
    from atmonr_tpu_torch.extract import runner

    offset, scale = np.array([4605974.0, -3856799.375, 2186897.625]), 487_331.2734375
    mid = midpoint_points(200_000, 12, offset, scale)
    xyz = np.concatenate([mid, ecef_points(2_000_003, 11)])
    want = ((xyz - offset[None]) / scale).astype(np.float32)
    got = runner.normalize(torch.from_numpy(xyz), torch.from_numpy(offset),
                           torch.tensor(scale, dtype=torch.float64))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    reciprocal = ((mid - offset[None]) * (1.0 / scale)).astype(np.float32)
    assert (reciprocal != want[: len(mid)]).any()

    b, small = 1000, xyz[: 5 * 1000 + 5]  # five full batches and a tail of 5
    pipe = _PointsSeen(scale, offset)
    run_extraction(pipe, small, batch_size=b)
    assert [len(x) for x in pipe.batches] == [b] * 5 + [5]
    np.testing.assert_array_equal(torch.cat(pipe.batches).numpy(), want[: len(small)])

    monkeypatch.setattr(runner, "_gather_shares", lambda local, shares, mesh: local)
    for rank in range(4):
        pipe = _PointsSeen(scale, offset)
        run_extraction(pipe, small, batch_size=b, mesh=_OneRankOf((2, 2), divmod(rank, 2)))
        expect = []
        for lo in range(0, len(small), b):
            rows = want[lo : min(lo + b, len(small))]
            m = -(-len(rows) // 4)
            mine = rows[rank * m : (rank + 1) * m]
            expect.append(np.concatenate([mine, np.zeros((m - len(mine), 3), np.float32)]))
        assert [len(x) for x in pipe.batches] == [250] * 5 + [2]
        np.testing.assert_array_equal(torch.cat(pipe.batches).numpy(), np.concatenate(expect))
    assert len(expect[-1]) == 2 and not expect[-1].any()  # rank 3 gets no row of the tail


def test_run_extraction_stages_no_batch_on_the_cpu(datasets):
    """``staged_batches`` counts the batches that went through the pinned
    ring, which only a card has: on the CPU it stays put."""
    _, tds = datasets
    tpipe = get_pipeline(_config("xla")["pipeline"], tds, device="cpu")
    grid = get_extract_dataset("l1c", tds, alt_step=2000.0)
    before = run_extraction.staged_batches
    run_extraction(tpipe, grid, batch_size=500)
    assert run_extraction.staged_batches == before


def test_run_extraction_makes_no_array_of_the_grid_size_on_the_host(datasets):
    """numpy reports its allocations to ``tracemalloc``: over a call on a
    grid of N points the traced peak stays under a tenth of the N x 12
    bytes a float32 copy of the normalized points would take (the points
    are normalized a batch at a time from views of the grid's rows)."""
    import tracemalloc

    _, tds = datasets
    tpipe = get_pipeline(_config("xla")["pipeline"], tds, device="cpu")
    grid = get_extract_dataset("l1c", tds, alt_step=100.0)
    n = len(grid)
    assert n > 20_000
    want = run_extraction(tpipe, grid, batch_size=4096)
    tracemalloc.start()
    try:
        got = run_extraction(tpipe, grid, batch_size=4096)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, want)
    assert peak < n * 12 // 10, (peak, n)


# -- writers -------------------------------------------------------------------

_SCALE_ATTRS = {"DIMENSION_LIST", "REFERENCE_LIST", "CLASS", "NAME"}


def _h5_tree(path) -> dict:
    """Every dataset's dtype, shape, values and attributes (the dimension
    scales by the names of the scales attached to each axis), and the root
    attributes."""

    def attrs(obj):
        return {k: np.asarray(v).tolist() for k, v in obj.attrs.items() if k not in _SCALE_ATTRS}

    with h5py.File(path, "r") as f:
        tree = {"/": attrs(f)}
        for name, ds in f.items():
            tree[name] = {
                "dtype": ds.dtype.str, "values": ds[()], "attrs": attrs(ds),
                "scale": ds.is_scale,
                "dims": [[s.name for s in d.values()] for d in ds.dims],
                "fill": np.asarray(ds.fillvalue).tolist(),
            }
    return tree


def _same_files(got, want) -> None:
    a, b = _h5_tree(got), _h5_tree(want)
    assert a.keys() == b.keys()
    assert a.pop("/") == b.pop("/")
    for name in a:
        x, y = a[name], b[name]
        np.testing.assert_array_equal(x.pop("values"), y.pop("values"), err_msg=name)
        assert x == y, name


def _sigma(n: int, bands: int = 1) -> np.ndarray:
    sigma = np.random.default_rng(6).uniform(0, 1e-3, (n, bands)).astype(np.float32)
    sigma[::17] = np.nan  # a query can return NaN; the writers pass it on
    return sigma


@pytest.mark.parametrize("case", ["l1c", "voxelgrid-2bands"])
def test_netcdf_writer_matches_jax(datasets, tmp_path, case):
    jds, tds = datasets
    mode = case.split("-")[0]
    kw = (dict(alt_step=2000.0) if mode == "l1c"
          else dict(horizontal_step=3000.0, alt_step=5000.0, dem_path=_dem(tmp_path)))
    tgrid, jgrid = get_extract_dataset(mode, tds, **kw), jax_get_extract_dataset(mode, jds, **kw)
    sigma = _sigma(len(tgrid), 2 if case.endswith("2bands") else 1)
    tgrid.dump(tmp_path / "t.nc", sigma)
    jgrid.dump(tmp_path / "j.nc", sigma)
    _same_files(tmp_path / "t.nc", tmp_path / "j.nc")
    with h5py.File(tmp_path / "t.nc", "r") as f:
        assert f["extinction_coefficient"].shape == tgrid.shp + (sigma.shape[1],)


@pytest.mark.parametrize("rng", [None, [5, 30]], ids=["track", "range"])
def test_earthcare_writer_matches_jax(datasets, tmp_path, rng):
    jds, tds = datasets
    write_synthetic_earthcare(tmp_path / "EarthCARE" / "track.h5")
    kw = dict(earthcare_filename="track.h5", earthcare_range=rng, data_root=tmp_path)
    tgrid = get_extract_dataset("earthcare", tds, **kw)
    jgrid = jax_get_extract_dataset("earthcare", jds, **kw)
    sigma = _sigma(len(tgrid))
    tgrid.dump(tmp_path / "t.nc", sigma)
    jgrid.dump(tmp_path / "j.nc", sigma)
    _same_files(tmp_path / "t.nc", tmp_path / "j.nc")


def test_global_grid_npy_fallback_matches_jax(datasets, tmp_path):
    """Without OpenVDB: ``<stem>_voxels.npy`` and ``<stem>_sigma.npy``
    beside the requested path, with a warning; a second dump warns that it
    overwrites."""
    jds, tds = datasets
    kw = dict(scale=GLOBAL_SCALE, grid_res=0.02, vstretch=4.0)
    tgrid = get_extract_dataset("globalgrid", tds, **kw)
    jgrid = jax_get_extract_dataset("globalgrid", jds, **kw)
    sigma = _sigma(len(tgrid))
    with pytest.warns(UserWarning, match="OpenVDB"):
        tgrid.dump(tmp_path / "t.vdb", sigma)
    with pytest.warns(UserWarning, match="OpenVDB"):
        jgrid.dump(tmp_path / "j.vdb", sigma)
    for part in ("voxels", "sigma"):
        got, want = np.load(tmp_path / f"t_{part}.npy"), np.load(tmp_path / f"j_{part}.npy")
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert np.load(tmp_path / "t_voxels.npy").shape == (len(tgrid), 3)
    assert not (tmp_path / "t.vdb").exists()
    with pytest.warns(UserWarning, match="overwriting"):
        tgrid.dump(tmp_path / "t.vdb", sigma)


def test_global_grid_vdb_writer_matches_jax(datasets, tmp_path, monkeypatch):
    """With the OpenVDB bindings (a recording stand-in here): the same grid
    calls in both packages."""
    import types

    jds, tds = datasets
    kw = dict(scale=GLOBAL_SCALE, grid_res=0.05, vstretch=12.0)
    grids = {"t": get_extract_dataset("globalgrid", tds, **kw),
             "j": jax_get_extract_dataset("globalgrid", jds, **kw)}
    sigma = np.nan_to_num(_sigma(len(grids["t"]))[:, 0])
    calls = []

    class FakeGrid:
        def copyFromArray(self, arr, ijk):
            calls[-1].append(("copy", arr.tolist(), list(map(int, ijk))))

    fake = types.SimpleNamespace(
        FloatGrid=FakeGrid,
        createLinearTransform=lambda voxelSize: ("transform", voxelSize),
        write=lambda path, grids: calls[-1].append(
            ("write", Path(path).suffix, grids[0].name, grids[0].transform,
             grids[0].saveFloatAsHalf, grids[0].vectorType)),
    )
    monkeypatch.setitem(sys.modules, "openvdb", fake)
    for key, grid in grids.items():
        calls.append([])
        grid.dump(tmp_path / f"{key}.vdb", sigma)
    assert len(calls[0]) == len(grids["t"]) + 1
    assert calls[0] == calls[1]


def test_writers_keep_h5py_out_of_import():
    """The extraction and its CLIs import where h5py is missing."""
    import subprocess

    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import atmonr_tpu_torch.extract, atmonr_tpu_torch.extract.orbit_render\n"
        "import atmonr_tpu_torch.scripts.extract, atmonr_tpu_torch.scripts.make_video\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'atmonr_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


# -- checkpoint restore and the CLI's refusals -------------------------------------


def test_restore_params_loads_the_latest_checkpoint(datasets, tmp_path):
    _, tds = datasets
    config = _config("q8")["pipeline"]
    saved = {e: get_pipeline(config, tds, device="cpu", generator=torch.Generator().manual_seed(e))
             for e in (1, 2)}
    with torch.no_grad():
        saved[2].occ.fill_(0.25)
    for e, pipe in saved.items():
        tckpt.save_checkpoint(tmp_path, e, {"pipeline": pipe.state_dict(), "epoch_idx": e})
    fresh = get_pipeline(config, tds, device="cpu")
    assert tckpt.restore_params(tmp_path, fresh) == 2
    for name, value in saved[2].state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name
    assert tckpt.restore_params(tmp_path, fresh, epoch=1) == 1
    assert torch.equal(fresh.pos_table, saved[1].pos_table)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_params(tmp_path / "none", fresh)


def test_extract_cli_refuses_mesh_and_bad_steps(tmp_path):
    """A ``--mesh`` larger than the world (one process here) raises naming
    the torchrun line, and leaves no process group behind; bad steps exit
    through the parser."""
    base = ["--exp-name", "x", "--extract-filename", "x.nc", "--data-root", str(tmp_path),
            "--device", "cpu"]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        extract_cli.main(base + ["--coord-mode", "l1c", "--mesh", "data=4"])
    assert not torch.distributed.is_initialized()
    with pytest.raises(SystemExit):
        extract_cli.main(base + ["--coord-mode", "l1c", "--alt-step", "0"])
    with pytest.raises(SystemExit):
        extract_cli.main(base + ["--coord-mode", "globalgrid", "--vstretch", "0.5"])
