"""The port's host library (``atmonr_tpu_torch/csrc/atmonr_native.cpp``
through ``atmonr_tpu_torch.native``), on the CPU: each entry point against
the port's own numpy version at the bounds ``tests/test_native.py`` holds
the JAX package's library to (the grid expansion, which that library
lacks, bit for bit), against that library bit for bit (same
source arithmetic, same flags, same machine), ``voxel_keys`` against the
keys of the walked rows, the dataset's default ray builder and global grid
built through it, and a build that fails raising with no numpy fallback.

``g++`` builds the library at first use into ``atmonr_tpu_torch/_build/``
(under a second of compile; the test workers share the built file). The
JAX package's library is built and loaded first (``_torch_jax_native``)."""

import threading

import numpy as np
import pytest

import _torch_jax_native
from _torch_jax_native import jax_native_library  # noqa: F401  (an autouse fixture)
from atmonr_tpu import native as jnative
from atmonr_tpu.data.harp2 import HARP2Dataset as JaxHARP2Dataset
from atmonr_tpu.data.synthetic import make_synthetic_granule
from atmonr_tpu_torch import _build, get_dataset, get_extract_dataset, native
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.extract import datasets as tdatasets
from atmonr_tpu_torch.extract.voxel_traversal import voxel_traversal, voxel_traversal_numpy
from atmonr_tpu_torch.geo import wgs84
from test_torch_pipeline import SCENE, _config


def _inputs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-60, 60, (n, 4))
    lon = rng.uniform(-170, 170, (n, 4))
    alt = rng.uniform(0, 3000, (n, 4))
    thetav = np.abs(rng.uniform(-45, 45, (n, 4)))
    phiv = rng.uniform(-180, 180, (n, 4))
    return lat, lon, alt, thetav, phiv


def _segments(case: str, n: int = 200):
    """(u, end) in voxel coordinates: random segments, or with zero-length
    and axis-aligned ones mixed in, or long ones across a 200-voxel box."""
    rng = np.random.default_rng(3)
    u = rng.uniform(-10, 10, (n, 3))
    end = u + rng.uniform(-20, 20, (n, 3))
    if case == "degenerate":
        end[:20] = u[:20]  # zero-length
        end[20:40, 1:] = u[20:40, 1:]  # along x
        end[40:60, :2] = u[40:60, :2]  # along z
        end[60:80, 0] = u[60:80, 0]  # in a plane of x
        end[80:100] = np.floor(u[80:100]) + 0.5  # inside the start voxel
    elif case == "long":
        end = u + rng.uniform(-200, 200, (n, 3))
    return u, end


def _box(u, end):
    ends = np.concatenate([u, end])
    lo = np.floor(ends.min(axis=0)).astype(np.int64) - 1
    return lo, np.floor(ends.max(axis=0)).astype(np.int64) + 2 - lo


def _rows(a) -> set:
    return set(map(tuple, np.asarray(a).tolist()))


# -- against the port's numpy versions ------------------------------------------


def test_build_rays_matches_numpy_within_solver_tol():
    """Each ray stops its origin solve on its own where the numpy path stops
    all of them together: both within the 10 m tolerance of the fixed
    point, so origins and lengths within 25 m, directions within 1e-5."""
    lat, lon, alt, thetav, phiv = _inputs()
    o_n, d_n, l_n = native.build_rays(lat, lon, alt, thetav, phiv, 20000.0)
    o_p, d_p, l_p = wgs84.get_rays(lat, lon, alt, thetav, phiv, 20000.0)
    assert o_n.dtype == d_n.dtype == l_n.dtype == np.float32
    assert o_n.shape == o_p.shape == (800, 3)
    assert np.abs(o_n - o_p).max() <= 25.0
    assert np.abs(d_n - d_p).max() < 1e-5
    assert np.abs(l_n - l_p.reshape(-1)).max() <= 25.0


def test_build_rays_origin_height():
    lat, lon, alt, thetav, phiv = _inputs()
    o, _, _ = native.build_rays(lat, lon, alt, thetav, phiv, 20000.0)
    _, _, alt_o = wgs84.cartesian_to_horizontal(*o.astype(np.float64).T, xp=np)
    assert np.abs(alt_o - 20000.0).max() < 15.0


@pytest.mark.parametrize("field", range(5), ids=["lat", "lon", "alt", "thetav", "phiv"])
def test_build_rays_propagates_nan(field):
    args = list(_inputs(10))
    args[field][3, 2] = np.nan
    o, d, ln = native.build_rays(*args, 20000.0)
    assert np.isnan(o.reshape(10, 4, 3)[3, 2]).all()
    assert not np.isnan(o.reshape(10, 4, 3)[0, 0]).any()
    assert np.isnan(ln.reshape(10, 4)[3, 2]) and np.isfinite(np.delete(ln, 3 * 4 + 2)).all()


def test_bulk_conversions_match_numpy():
    rng = np.random.default_rng(1)
    lat = rng.uniform(-80, 80, (25, 20))
    lon = rng.uniform(-179, 179, (25, 20))
    alt = rng.uniform(0, 10000, (25, 20))
    got = native.horizontal_to_cartesian(lat, lon, alt)
    want = wgs84.horizontal_to_cartesian(lat, lon, alt)
    for g, w in zip(got, want):
        assert g.shape == (25, 20)
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    la1, lo1, al1 = native.cartesian_to_horizontal(*got)
    la2, lo2, al2 = wgs84.cartesian_to_horizontal(*got, xp=np)
    np.testing.assert_allclose(la1, la2, atol=1e-12, rtol=0)
    np.testing.assert_allclose(lo1, lo2, atol=1e-12, rtol=0)
    np.testing.assert_allclose(al1, al2, atol=1e-6, rtol=0)


def _grid_case(case: str):
    """(lat, lon, ladder) of one case of the grid expansion."""
    rng = np.random.default_rng(7)
    lat, lon = rng.uniform(-80, 80, (16, 8)), rng.uniform(-179, 179, (16, 8))
    ladder = np.arange(0.0, 20000.0 + 12.5, 25.0)  # the benchmark cell's ladder
    if case == "min-max":
        ladder = np.arange(1000.0, 6000.0 + 250.0, 500.0)
    elif case == "f32":
        lat, lon, ladder = lat.astype(np.float32), lon.astype(np.float32), ladder.astype(np.float32)
    elif case == "strided":
        lat, lon = rng.uniform(-80, 80, (8, 16)).T, rng.uniform(-179, 179, (32, 8))[::2]
    elif case == "poles":
        lat[0], lat[1] = 90.0, -90.0
        lon[:, 0], lon[:, 1] = 180.0, -180.0
    elif case == "zero-pixels":  # all-NaN pixels, mapped to 0 as the L1C grid maps them
        lat[2:5], lon[2:5] = np.nan, np.nan
        lat, lon = np.nan_to_num(lat), np.nan_to_num(lon)
    elif case == "no-pixels":
        lat, lon = lat[:0], lon[:0]
    elif case == "empty-ladder":
        ladder = ladder[:0]
    return lat, lon, ladder


@pytest.mark.parametrize("case", ["ladder", "min-max", "f32", "strided", "poles", "zero-pixels",
                                  "no-pixels", "empty-ladder"])
def test_grid_to_cartesian_equals_numpy_bit_for_bit(case):
    """The library's expansion of the per-pixel terms over the ladder is
    ``wgs84.horizontal_grid_to_cartesian``'s, bit for bit: (H, W, na, 3)
    C-contiguous float64, and the counter moves by the points written."""
    lat, lon, ladder = _grid_case(case)
    before = native.horizontal_grid_to_cartesian.points
    got = native.horizontal_grid_to_cartesian(lat, lon, ladder)
    want = wgs84.horizontal_grid_to_cartesian(lat, lon, ladder)
    assert got.shape == want.shape == lat.shape + ladder.shape + (3,)
    assert got.dtype == np.float64 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    assert native.horizontal_grid_to_cartesian.points - before == lat.size * ladder.size


@pytest.mark.parametrize("case", ["random", "degenerate", "long"])
def test_voxel_traversal_matches_numpy(case):
    """The same voxel set as the numpy walk, segment by segment; every
    segment starts at its start voxel and takes unit steps."""
    u, end = _segments(case)
    vox, counts = native.voxel_traversal(u, end)
    assert vox.dtype == counts.dtype == np.int32
    assert counts.shape == (u.shape[0],) and (counts >= 1).all() and counts.sum() == len(vox)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    np.testing.assert_array_equal(vox[starts], np.floor(u).astype(np.int32))
    steps = np.abs(np.diff(vox, axis=0)).sum(axis=1)
    inside = np.ones(len(vox) - 1, bool)
    inside[starts[1:] - 1] = False  # no step between two segments
    assert np.all(steps[inside] == 1)
    for i in range(0, u.shape[0], 7):
        seg = vox[starts[i]:starts[i] + counts[i]]
        assert _rows(seg) == _rows(voxel_traversal_numpy(u[i:i + 1], end[i:i + 1])), i
    if case == "degenerate":
        assert np.all(counts[:20] == 1) and np.all(counts[80:100] == 1)


@pytest.mark.parametrize("unique_only", [True, False], ids=["unique", "all"])
def test_voxel_traversal_takes_the_library_in_3d(unique_only):
    """``voxel_traversal`` walks 3-D segments in the library (its rows, in
    walk order) and 2-D ones in numpy; unique rows equal the numpy walk's."""
    u, end = _segments("degenerate")
    got = voxel_traversal(u, end, unique_only=unique_only)
    if unique_only:
        np.testing.assert_array_equal(got, voxel_traversal_numpy(u, end))
    else:
        np.testing.assert_array_equal(got, native.voxel_traversal(u, end)[0])
    u2, end2 = u[:, :2], end[:, :2]
    np.testing.assert_array_equal(voxel_traversal(u2, end2, unique_only),
                                  voxel_traversal_numpy(u2, end2, unique_only))


@pytest.mark.parametrize("case", ["random", "degenerate", "long"])
def test_voxel_keys_are_the_walked_rows_keys(case):
    """One int64 per walked voxel, in walk order: ``_voxel_keys`` of the
    library's rows, and as a set the keys of the numpy walk's rows."""
    u, end = _segments(case)
    lo, width = _box(u, end)
    keys = native.voxel_keys(u, end, lo, width)
    assert keys.dtype == np.int64
    np.testing.assert_array_equal(keys, tdatasets._voxel_keys(native.voxel_traversal(u, end)[0],
                                                              lo, width))
    np.testing.assert_array_equal(np.unique(keys),
                                  np.unique(tdatasets.walk_keys_numpy(u, end, lo, width)))


@pytest.mark.parametrize("shift", [(0, 3, 0), (0, 0, -3)], ids=["lo-up", "width-down"])
def test_voxel_keys_raise_outside_the_box(shift):
    u, end = _segments("long")
    lo, width = _box(u, end)
    if sum(shift) > 0:
        lo = lo + np.array(shift)
    else:
        width = width + np.array(shift)
    with pytest.raises(ValueError, match="outside the rays' bounding box"):
        native.voxel_keys(u, end, lo, width)
    with pytest.raises(ValueError, match="outside the rays' bounding box"):
        tdatasets.walk_keys_numpy(u, end, lo, width)


def test_empty_and_malformed_inputs():
    empty = np.zeros((0, 3))
    vox, counts = native.voxel_traversal(empty, empty)
    assert vox.shape == (0, 3) and counts.shape == (0,)
    assert native.voxel_keys(empty, empty, np.zeros(3), np.ones(3)).shape == (0,)
    with pytest.raises(ValueError, match="same"):
        native.voxel_traversal(np.zeros((4, 3)), np.zeros((4, 2)))
    with pytest.raises(ValueError, match="width"):
        native.voxel_keys(np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(3), np.zeros(3))
    assert native.num_threads() >= 1


# -- against the JAX package's library ---------------------------------------------


def test_the_jax_library_loads_again_after_a_fallback(monkeypatch):
    """A process whose first load fell back to numpy (the library not yet
    whole) loads it once the helper has built it."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_tried", True)
    assert not jnative.available()
    _torch_jax_native.build()
    assert jnative.available() and jnative._lib is not None


@pytest.mark.parametrize("entry", ["build_rays", "h2c", "c2h", "voxel_traversal"])
def test_equal_to_the_jax_packages_library(entry):
    """The same arithmetic under the same flags on the same machine: equal
    bit for bit."""
    lat, lon, alt, thetav, phiv = _inputs(seed=5)
    if entry == "build_rays":
        pairs = zip(native.build_rays(lat, lon, alt, thetav, phiv, 20000.0),
                    jnative.build_rays(lat, lon, alt, thetav, phiv, 20000.0))
    elif entry == "h2c":
        pairs = zip(native.horizontal_to_cartesian(lat, lon, alt),
                    jnative.horizontal_to_cartesian(lat, lon, alt))
    elif entry == "c2h":
        xyz = wgs84.horizontal_to_cartesian(lat, lon, alt)
        pairs = zip(native.cartesian_to_horizontal(*xyz), jnative.cartesian_to_horizontal(*xyz))
    else:
        u, end = _segments("degenerate")
        pairs = zip(native.voxel_traversal(u, end), jnative.voxel_traversal(u, end))
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_datasets_default_builders_agree_with_the_jax_package():
    """Both packages' default builders are their host libraries: the same
    rays; the port's numpy builder within the solver's 25 m."""
    config = _config("xla")
    granule = make_synthetic_granule(height=16, width=8, views_per_band=2)
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    jds = JaxHARP2Dataset(config["dataset"], granule)
    for k in ("ray_origin", "ray_dir", "ray_len"):
        np.testing.assert_array_equal(getattr(tds, k), getattr(jds, k))
    assert tds.scale == jds.scale
    pds = HARP2Dataset(config["dataset"], granule, device="cpu", ray_builder=wgs84.get_rays)
    np.testing.assert_array_equal(pds.ray_filter, tds.ray_filter)
    assert 0 < np.abs(pds.ray_origin - tds.ray_origin).max() <= 25.0
    assert np.abs(pds.ray_dir - tds.ray_dir).max() < 1e-5


def test_global_grid_numpy_walk_gives_the_same_grid():
    """The global grid with ``walk_keys_numpy``: the same voxels and points,
    in the same order, as with the library's keys."""
    config = _config("xla")
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    kw = dict(scale=100 / 6.378e6, grid_res=0.02, vstretch=12.0)
    got = get_extract_dataset("globalgrid", tds, **kw)
    want = get_extract_dataset("globalgrid", tds, walk_keys=tdatasets.walk_keys_numpy, **kw)
    assert len(got) > 100
    np.testing.assert_array_equal(got.voxels, want.voxels)
    np.testing.assert_array_equal(got.xyz, want.xyz)


# -- the build -----------------------------------------------------------------------


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """A compiler that does not exist: ``build_host`` raises naming g++,
    and so does every entry point (no numpy fallback)."""
    with pytest.raises(RuntimeError, match=r"g\+\+ \(/nonexistent/g\+\+\) cannot be run"):
        _build.build_host("atmonr_native", gxx="/nonexistent/g++")
    monkeypatch.setattr(_build, "GXX", "/nonexistent/g++")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lat, lon, alt, thetav, phiv = _inputs(4)
    calls = [
        lambda: native.build_rays(lat, lon, alt, thetav, phiv, 20000.0),
        lambda: native.cartesian_to_horizontal(lat, lon, alt),
        lambda: native.horizontal_grid_to_cartesian(lat, lon, alt[0]),
        lambda: native.voxel_traversal(*_segments("random", 4)),
        lambda: native.voxel_keys(*_segments("random", 4), np.zeros(3), np.ones(3)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            call()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        get_dataset(_config("xla")["dataset"], SCENE, device="cpu")
    assert not list(tmp_path.iterdir())


def test_builds_at_once_land_one_library(monkeypatch, tmp_path):
    """Four builds of one source into an empty build directory at the same
    time (as test workers may start): each returns the same library, it
    loads and runs, and no temporary file is left."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(_build.build_host("atmonr_native")[0])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1 and [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    import ctypes

    assert ctypes.CDLL(str(paths[0])).atmonr_num_threads() >= 1
