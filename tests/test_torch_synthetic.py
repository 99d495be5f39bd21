"""The port's synthetic granule writers and the surface-biased sampler
against the JAX package's, on the CPU.

Each writer of ``atmonr_tpu_torch/data/synthetic.py`` writes the same file
as its JAX counterpart: every group and dataset, dtype, value (NaN where
NaN), attribute and dimension scale, read back with h5py. The real-schema
granule reaches ``HARP2Dataset`` by two routes, its file through
``read_granule`` and ``real_schema_granule`` with no file: both give JAX's
``read_granule`` of JAX's file, bit for bit, and the same rays.
``sample_biased_bins`` agrees with JAX's to 1e-6 (float32 square roots and
products).
"""

from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmonr_tpu.data import synthetic as jsyn
from atmonr_tpu.data.granule import read_granule as jax_read_granule
from atmonr_tpu.ops.samplers import sample_biased_bins as jax_sample_biased_bins
from atmonr_tpu_torch.data import synthetic as tsyn
from atmonr_tpu_torch.data.factory import get_dataset
from atmonr_tpu_torch.data.granule import read_granule
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.ops.samplers import sample_biased_bins

FIELDS = ("lat", "lon", "alt", "thetav", "phiv", "i", "view_angles", "wavelengths")
DATASET_CONFIG = {"type": "HARP2", "max_abs_view_angle": 45.0, "ray_origin_height": 20000,
                  "bands_to_keep": [0, 1, 2, 3], "rgb_mode": "nadir"}
# (height, width, n_blobs, blob_max, noise): the smooth scene and a
# broken-cloud one
REAL_SCENES = [(12, 9, 1, 0.5, 0.01), (14, 10, 6, 0.6, 0.002)]


def _contents(path: Path) -> dict:
    """Every object of an HDF5 file: the root's attributes; per group its
    attributes; per dataset its dtype, values, attributes (dimension
    references as the names of the scales attached to each axis) and
    whether it is a scale."""
    def attrs(obj):
        return {k: v for k, v in obj.attrs.items()
                if k not in ("DIMENSION_LIST", "REFERENCE_LIST")}

    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = attrs(f)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = {
                    "dtype": obj.dtype, "value": obj[()], "attrs": attrs(obj),
                    "dims": [[s.name for s in d.values()] for d in obj.dims],
                    "is_scale": obj.is_scale,
                }
            else:
                out[name] = {"attrs": attrs(obj)}

        f.visititems(visit)
    return out


def _assert_same_files(got: Path, want: Path) -> None:
    a, b = _contents(got), _contents(want)
    assert a.keys() == b.keys()
    for name in b:
        ga = a[name] if name == "/" else a[name]["attrs"]
        wa = b[name] if name == "/" else b[name]["attrs"]
        assert ga.keys() == wa.keys(), name
        for k in wa:
            assert type(ga[k]) is type(wa[k]), (name, k)
            assert np.array_equal(ga[k], wa[k]), (name, k)
        if name == "/" or "value" not in b[name]:
            continue
        g, w = a[name], b[name]
        assert g["dtype"] == w["dtype"], name
        equal_nan = np.issubdtype(w["dtype"], np.floating)
        assert np.array_equal(g["value"], w["value"], equal_nan=equal_nan), name
        assert g["dims"] == w["dims"] and g["is_scale"] == w["is_scale"], name


def _write_l1b(mod, path):
    granule = mod.make_synthetic_granule(height=10, width=7, views_per_band=2, seed=3)
    mod.write_granule_l1b(granule, path)


def _write_l1c(mod, path):
    mod.write_granule_l1c(path, height=9, width=5)


def _write_earthcare(mod, path):
    mod.write_synthetic_earthcare(path, n_along=17, n_height=6)


def _write_dem(mod, path):
    h = np.random.default_rng(5).uniform(-50.0, 900.0, (6, 8))
    mod.write_synthetic_dem(path, h, upper_lat=21.0, left_lon=-41.0, lat_res=0.1,
                            lon_res=0.1)


def _write_dem_water(mod, path):
    rng = np.random.default_rng(6)
    mod.write_synthetic_dem(path, rng.uniform(0.0, 10.0, (3, 4)),
                            water_surface_height=rng.uniform(0.0, 10.0, (3, 4)))


def _writer_real(scene):
    h, w, n_blobs, blob_max, noise = scene

    def write(mod, path):
        mod.write_granule_l1b_real_schema(path, height=h, width=w, seed=4, n_blobs=n_blobs,
                                          blob_max=blob_max, noise=noise)

    return write


WRITERS = {
    "l1b": _write_l1b,
    "l1c": _write_l1c,
    "earthcare": _write_earthcare,
    "dem": _write_dem,
    "dem with water": _write_dem_water,
    "l1b real schema smooth": _writer_real(REAL_SCENES[0]),
    "l1b real schema broken cloud": _writer_real(REAL_SCENES[1]),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_writers_write_jax_files(writer, tmp_path):
    """The same file name in two directories, so that ``product_name``
    agrees too."""
    name = "PACE_HARP2.20240101T000000.L1B.V3.SYNTHETIC.nc"
    WRITERS[writer](tsyn, tmp_path / "port" / name)
    WRITERS[writer](jsyn, tmp_path / "jax" / name)
    _assert_same_files(tmp_path / "port" / name, tmp_path / "jax" / name)


@pytest.mark.parametrize("scene", REAL_SCENES, ids=["smooth", "broken cloud"])
def test_real_schema_routes_give_one_granule(scene, tmp_path):
    """``read_granule`` of the port's file, ``real_schema_granule`` and JAX's
    ``read_granule`` of JAX's file: every field with its dtype, NaN at the
    same places (fill, striped views, the swath edge), bit for bit."""
    h, w, n_blobs, blob_max, noise = scene
    name = tsyn.REAL_SCHEMA_NAME
    kw = {"height": h, "width": w, "seed": 9, "n_blobs": n_blobs, "blob_max": blob_max,
          "noise": noise}
    tsyn.write_granule_l1b_real_schema(tmp_path / "port" / name, **kw)
    jsyn.write_granule_l1b_real_schema(tmp_path / "jax" / name, **kw)
    from_file = read_granule(tmp_path / "port" / name)
    in_memory = tsyn.real_schema_granule(**kw)
    want = jax_read_granule(tmp_path / "jax" / name)
    for got in (from_file, in_memory):
        assert (got.level, got.product_name) == (want.level, want.product_name)
        for field in FIELDS:
            g, wv = getattr(got, field), getattr(want, field)
            assert g.dtype == wv.dtype and g.shape == wv.shape, field
            assert np.array_equal(g, wv, equal_nan=True), field
    assert np.isnan(in_memory.i[:, :, 0]).all()  # the swath edge
    assert in_memory.i.shape == (90, h, w)


def test_real_schema_routes_give_one_dataset(tmp_path):
    """The two routes through ``HARP2Dataset``: the same rays, scale and
    offset, so the view and fill filters kept the same rays."""
    kw = {"height": 12, "width": 9, "seed": 2, "n_blobs": 3, "blob_max": 0.6, "noise": 0.002}
    tsyn.write_granule_l1b_real_schema(tmp_path / "HARP2" / tsyn.REAL_SCHEMA_NAME, **kw)
    a = get_dataset(DATASET_CONFIG, tsyn.REAL_SCHEMA_NAME, data_root=tmp_path, device="cpu")
    b = HARP2Dataset(DATASET_CONFIG, tsyn.real_schema_granule(**kw), device="cpu")
    assert a.num_rays == b.num_rays > 0
    assert (a.scale, tuple(a.offset)) == (b.scale, tuple(b.offset))
    for k, v in a.host_rays().items():
        assert np.array_equal(v, b.host_rays()[k]), k


@pytest.mark.parametrize("draws", ["midpoints", "given"])
@pytest.mark.parametrize("alpha", [0.3, 1.0])
def test_sample_biased_bins_matches_jax(alpha, draws):
    rng = np.random.default_rng(11)
    b, n = 53, 24
    rays = {"origin": rng.normal(size=(b, 3)).astype(np.float32),
            "dir": rng.normal(size=(b, 3)).astype(np.float32),
            "len": rng.uniform(0.5, 2.0, b).astype(np.float32)}
    key = None if draws == "midpoints" else jax.random.PRNGKey(4)
    jpts, jz = jax_sample_biased_bins({k: jnp.asarray(v) for k, v in rays.items()}, n,
                                      20000.0, alpha, key)
    t = None if key is None else torch.from_numpy(np.array(jax.random.uniform(key, (b, n))))
    tpts, tz = sample_biased_bins({k: torch.from_numpy(v) for k, v in rays.items()}, n,
                                  20000.0, alpha, t)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=1e-6, atol=1e-6)
    assert bool((tz[:, 1:] >= tz[:, :-1]).all())


def test_sample_biased_bins_draws_from_a_generator():
    """Draws from a ``torch.Generator`` are the given draws of the same
    generator's ``rand``; ``alpha`` outside [0, 1] and both sources at once
    are refused."""
    rays = {"origin": torch.zeros(5, 3), "dir": torch.ones(5, 3), "len": torch.ones(5)}
    _, z = sample_biased_bins(rays, 8, 20000.0, 0.5, generator=torch.Generator().manual_seed(1))
    t = torch.rand((5, 8), generator=torch.Generator().manual_seed(1))
    assert torch.equal(z, sample_biased_bins(rays, 8, 20000.0, 0.5, t)[1])
    with pytest.raises(ValueError, match="alpha"):
        sample_biased_bins(rays, 8, 20000.0, 1.5)
    with pytest.raises(ValueError, match="not both"):
        sample_biased_bins(rays, 8, 20000.0, 0.5, t, torch.Generator())
