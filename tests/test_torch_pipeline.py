"""The port's inference slice against the JAX package, on the CPU: the ray
set, the occupancy refresh, the forward render, the extinction query and
``run_extraction``, on a small Instant-NGP config with the flagship's
structure (occupancy sampler, horizontal preprocessor, 3-D and 2-D hash
grids, SH direction encoding).

Both packages get the same parameters (``convert.params_from_jax``) and
``compute_dtype`` float32, as the JAX parity tests use. Two variants:
both encodings ``"xla"`` (the exact f32 gather), and both ``"q8"``. On the
CPU the JAX dispatch runs f32 whatever the mode, so the q8 variant
monkeypatches ``atmonr_tpu.models.hash_grid._fwd_dispatch`` to call the
Pallas q8 kernel in interpret mode.
"""

import copy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmonr_tpu_torch
from atmonr_tpu.data.harp2 import HARP2Dataset as JaxHARP2Dataset
from atmonr_tpu.data.synthetic import make_synthetic_granule
from atmonr_tpu.extract.runner import run_extraction as jax_run_extraction
from atmonr_tpu.geo import wgs84 as jwgs84
from atmonr_tpu.models import hash_grid as jhg
from atmonr_tpu.ops.hash_gather_pallas import hash_encode_pallas_fwd
from atmonr_tpu.pipelines.instant_ngp import InstantNGPPipeline as JaxPipeline
from atmonr_tpu_torch import convert, get_dataset, get_pipeline, run_extraction
from atmonr_tpu_torch.data.factory import _synthetic_from_name
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.geo import wgs84 as twgs84

SCENE = "synthetic:16x8x2"
N_RAYS = 48


def _config(mode: str) -> dict:
    hash_opts = {
        "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
        "log2_hashmap_size": 9, "per_level_scale": 1.5, "fwd_mode": mode,
    }
    return {
        "dataset": {
            "type": "HARP2", "max_abs_view_angle": 45.0,
            "ray_origin_height": 20000, "bands_to_keep": [0, 1, 2, 3],
            "rgb_mode": "nadir",
        },
        "pipeline": {
            "type": "InstantNGP", "include_height": False,
            "point_preprocessor": "horizontal", "num_bands": 4,
            "multi_band_extinction": False, "alt_compress_factor": 8,
            "loss": "mse_plus_hdr", "num_samples_per_ray": 16,
            "instant_ngp": {
                "encoding": dict(hash_opts, base_resolution=4, stochastic_rounding=True),
                "network": {"n_neurons": 16, "n_hidden_layers": 1},
                "dir_encoding": {"otype": "Composite", "nested": [
                    {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2},
                    {"otype": "Identity"},
                ]},
                "rgb_network": {"n_neurons": 16, "n_hidden_layers": 2},
                "surface_encoding": {"otype": "Composite", "nested": [
                    dict(hash_opts, n_dims_to_encode=2, base_resolution=16),
                    {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2},
                ]},
                "surface_network": {"n_neurons": 16, "n_hidden_layers": 2},
            },
            "occupancy": {"resolution": [8, 8, 4], "n_probe": 8, "n_fine": 6,
                          "decay": 0.8, "floor": 0.05},
        },
    }


def _jax_dataset(config):
    # the numpy float64 ray builder, as _port_dataset builds rays
    return JaxHARP2Dataset(
        config["dataset"],
        make_synthetic_granule(height=16, width=8, views_per_band=2),
        ray_builder=lambda *a, **k: jwgs84.get_rays(*a, **k, xp=np),
    )


def _port_dataset(dataset_config):
    """The port's dataset of ``SCENE`` on the CPU with the numpy float64 ray
    builder, the rays of ``_jax_dataset`` (the default, the host library,
    places origins up to 25 m away: ``tests/test_torch_native.py``)."""
    return HARP2Dataset(dataset_config, _synthetic_from_name(SCENE), device="cpu",
                        ray_builder=twgs84.get_rays)


def _q8_dispatch(table, x, cfg, sr_noise=None, tiles=None):
    return hash_encode_pallas_fwd(table, x, cfg, "q8", sr_noise)


class _Grid:
    """An extraction grid: ECEF points as ``.xyz``."""

    def __init__(self, xyz):
        self.xyz = xyz


def _grid_points(ds, n, seed):
    """ECEF points inside the scene box, along the granule's rays."""
    rng = np.random.default_rng(seed)
    host = ds.host_rays()
    i = rng.integers(0, len(host["len"]), n)
    t = rng.uniform(0.0, 1.0, n) * host["len"][i]
    pts = host["origin"][i] + host["dir"][i] * t[:, None]
    return pts.astype(np.float64) * ds.scale + ds.offset[None]


def _host_preprocess(st):
    """The "horizontal" preprocessor in float64 numpy, rounded to float32
    once at the end: one function both packages can share."""

    def pre(pts):
        xyz = np.asarray(pts, np.float64) * st.scale + np.asarray(st.offset)
        lat, lon, alt = jwgs84.cartesian_to_horizontal(
            xyz[..., 0], xyz[..., 1], xyz[..., 2], xp=np
        )
        lat = 2.0 * (lat - st.lat_min) / st.lat_range - 1.0
        lon = 2.0 * (lon - st.lon_min) / st.lon_range - 1.0
        alt = 2.0 * alt / st.ray_origin_height - 1.0
        return np.clip(np.stack([lat, lon, alt], -1), -1.0, 1.0).astype(np.float32)

    return pre


def _share_preprocessor(jpipe, tpipe, st):
    pre = _host_preprocess(st)

    def jax_pre(pts):  # works eagerly and under jit
        return jax.pure_callback(pre, jax.ShapeDtypeStruct(pts.shape, jnp.float32), pts)

    jpipe.point_preprocessor = jax_pre
    tpipe.point_preprocessor = lambda pts: torch.from_numpy(pre(pts.numpy()))


@pytest.fixture(scope="module", params=["xla", "q8"])
def run(request):
    """Everything the tests compare, computed once per variant.

    The forward runs once with each package's own float32 preprocessor
    (``real``). Everything after it runs with one float64 host
    preprocessor shared by both (``_share_preprocessor``): the float32
    ECEF -> lat/lon/alt conversion differs between XLA:CPU and torch by
    ulps of its transcendentals, ~1.5 m in altitude (checked on its own in
    ``test_preprocess_points_matches_jax``), and sharing it holds the rest
    of the slice to tight tolerances."""
    mode = request.param
    config = _config(mode)
    with pytest.MonkeyPatch.context() as mp:
        if mode == "q8":
            mp.setattr(jhg, "_fwd_dispatch", _q8_dispatch)
        jds = _jax_dataset(config)
        jpipe = JaxPipeline(config["pipeline"], jds)
        jpipe.compute_dtype = jnp.float32
        params = jpipe.init_params(jax.random.PRNGKey(0))

        tds = _port_dataset(config["dataset"])
        tpipe = get_pipeline(copy.deepcopy(config["pipeline"]), tds, device="cpu")
        tpipe.compute_dtype = torch.float32
        tpipe.load_params(convert.params_from_jax(params))

        # occupancy refresh with jitter, re-derived from the JAX key
        k_occ = jax.random.PRNGKey(1)
        aux = jpipe.update_aux(params, jpipe.init_aux(), k_occ)
        jitter = jax.random.uniform(k_occ, (jpipe.occ_cfg.num_cells, 3))
        tpipe.update_aux(jitter=torch.tensor(np.asarray(jitter)))

        rays = {k: v[:N_RAYS] for k, v in tds.host_rays().items()}
        jbatch = {k: jnp.asarray(v) for k, v in rays.items()}
        tbatch = {k: torch.from_numpy(v) for k, v in rays.items()}
        real = (jpipe.forward(params, jbatch, key=None, aux=aux), tpipe(tbatch))

        _share_preprocessor(jpipe, tpipe, jds.scene_transform)
        det = (jpipe.forward(params, jbatch, key=None, aux=aux), tpipe(tbatch))

        # a stochastic forward: the draws JAX makes from the key, passed in
        key = jax.random.PRNGKey(2)
        key2, k_sr = jax.random.split(key)
        kp, kf = jax.random.split(key2)
        oc = jpipe.occ_cfg
        draws = {
            "sr_noise": jax.random.uniform(k_sr, params["pos_table"].shape),
            "probe": jax.random.uniform(kp, (N_RAYS, oc.n_probe)),
            "fine": jax.random.uniform(kf, (N_RAYS, oc.n_fine), maxval=1.0 / oc.n_fine),
        }
        sto = (
            jpipe.forward(params, jbatch, key=key, aux=aux),
            tpipe(tbatch, draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()}),
        )

        pts = np.random.default_rng(3).uniform(-1, 1, (200, 3)).astype(np.float32)
        ext = (jpipe.extract(params, jnp.asarray(pts)), tpipe.extract(torch.from_numpy(pts)))
        grid = _Grid(_grid_points(tds, 1000, 4))
        runx = (
            jax_run_extraction(jpipe, params, grid, batch_size=256),
            run_extraction(tpipe, grid, batch_size=256),
        )
    return {
        "mode": mode, "jds": jds, "tds": tds, "params": params, "tpipe": tpipe,
        "occ": (aux["occ"], tpipe.occ), "real": real, "det": det, "sto": sto,
        "ext": ext, "runx": runx, "n_fine": oc.n_fine,
    }


def _np(a):
    # the port's forward runs under autograd: its outputs carry a graph
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_ray_set_and_scene_transform_match_jax(run):
    jds, tds = run["jds"], run["tds"]
    jr, tr = jds.host_rays(), tds.host_rays()
    assert jr.keys() == tr.keys()
    for k in jr:
        np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
    assert tds.scale == jds.scale
    np.testing.assert_array_equal(tds.offset, jds.offset)
    assert tds.scene_transform.__dict__ == jds.scene_transform.__dict__
    assert tds.max_i == jds.max_i
    rays = tds.rays()
    assert rays["origin"].device.type == "cpu" and rays["origin"].dtype == torch.float32


def test_preprocess_points_matches_jax(run):
    """float32 ECEF -> normalized (lat, lon, alt). Tolerances: 4 float32
    ulps of the largest |lat| or |lon| in degrees over the scene's range,
    and the 6 m float32 altitude floor (JAX package's geo/wgs84.py) over
    half the 20 km normalization."""
    st = run["jds"].scene_transform
    assert run["tds"].scene_transform == type(run["tds"].scene_transform)(**st.__dict__)
    pts = np.random.default_rng(5).uniform(-1, 1, (4000, 3)).astype(np.float32)
    j = np.asarray(st.preprocess_points(jnp.asarray(pts)))
    t = run["tds"].scene_transform.preprocess_points(torch.from_numpy(pts)).numpy()
    lat, lon, _ = (np.abs(c) for c in _host_preprocess(st)(pts).T)
    deg_lat = np.spacing(np.float32(abs(st.lat_min) + st.lat_range))
    deg_lon = np.spacing(np.float32(abs(st.lon_min) + st.lon_range))
    atol = np.array([
        2 * 4 * deg_lat / st.lat_range,
        2 * 4 * deg_lon / st.lon_range,
        2 * 6.0 / st.ray_origin_height,
    ])
    assert np.all(np.abs(t - j) <= atol), (np.abs(t - j).max(0), atol)


def test_occupancy_refresh_matches_jax(run):
    jocc, tocc = run["occ"]
    np.testing.assert_allclose(_np(tocc), _np(jocc), rtol=1e-5, atol=1e-9)


# outputs computed from alpha = 1 - exp(-sigma * delta): exp rounds to an
# ulp of 1.0 that can differ between XLA:CPU and torch, an absolute error
# of 2^-24 per alpha that no relative tolerance covers when alpha is small
_FROM_ALPHA = ("weights_fine", "color_map_atmo", "color_map_fine")


def _bad_rays(jout, tout, n_fine):
    """Rays where any output differs by more than rtol 1e-5 plus atol 1e-6
    of that output's largest value (plus, for the outputs composited from
    alpha, n_fine ulps of 1.0 per unit of color)."""
    assert jout.keys() == tout.keys()
    bad = np.zeros(N_RAYS, bool)
    for k in jout:
        j, t = _np(jout[k]), _np(tout[k])
        assert j.shape == t.shape, k
        assert np.all(np.isfinite(t)), k
        atol = 1e-6 * np.abs(j).max()
        if k in _FROM_ALPHA:
            atol += n_fine * 2.0**-24 * max(1.0, float(np.abs(j).max()))
        err = np.abs(t - j) > 1e-5 * np.abs(j) + atol
        bad |= err.reshape(N_RAYS, -1).any(axis=1)
    return np.flatnonzero(bad)


def test_forward_deterministic_matches_jax(run):
    """The samplers are discontinuous (a probe's cell, a CDF rank): a
    reduction taken in another order can move a rare ray's samples. At
    most one ray of the 48 may differ."""
    bad = _bad_rays(*run["det"], run["n_fine"])
    assert len(bad) <= 1, bad


def test_forward_with_draws_matches_jax(run):
    bad = _bad_rays(*run["sto"], run["n_fine"])
    assert len(bad) <= 1, bad


def test_forward_own_preprocessors(run):
    """With each package's own float32 preprocessor the encoder inputs
    differ by up to ~1.5e-4 in altitude (see above). The sample placement
    and the rendered colors still agree (rtol 1e-5, atol 1e-6 of the
    largest value) on all but at most 2 of the 48 rays."""
    jout, tout = run["real"]
    bad = np.zeros(N_RAYS, bool)
    for k in ("z_vals_fine", "color_surf", "color_map_fine"):
        j, t = _np(jout[k]), _np(tout[k])
        err = np.abs(t - j) > 1e-5 * np.abs(j) + 1e-6 * np.abs(j).max()
        bad |= err.reshape(N_RAYS, -1).any(axis=1)
    assert bad.sum() <= 2, np.flatnonzero(bad)


def test_extract_matches_jax(run):
    j, t = (_np(a) for a in run["ext"])
    assert t.shape == j.shape == (200, 1)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6 * np.abs(j).max())


def test_run_extraction_matches_jax(run):
    """JAX runs the query under jit, where XLA turns a division by a
    constant into a product with its rounded reciprocal: rtol 1e-5."""
    j, t = run["runx"]
    assert t.shape == j.shape == (1000, 1) and t.dtype == np.float32
    assert np.all(np.isfinite(t)) and np.all(t >= 0)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6 * np.abs(j).max())


def test_convert_round_trip(run):
    params, tpipe = run["params"], run["tpipe"]
    state = dict(tpipe.named_parameters())
    back = convert.params_to_jax(state, len(tpipe.surf_specs))
    leaves_a, tree_a = jax.tree_util.tree_flatten(params)
    leaves_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert set(convert.params_from_jax(back)) == set(state)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _config("q8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_dataset(config["dataset"], SCENE)
    ds = get_dataset(config["dataset"], SCENE, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_pipeline(config["pipeline"], ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.rays("cuda")


def test_nerf_and_uniform_sampler_wait():
    """Nothing waits any more: ``configs/nerf.json`` builds a NeRF pipeline,
    a config without ``occupancy`` builds an Instant-NGP pipeline with the
    uniform sampler, and ``include_height`` with it a 4-D position grid;
    ``include_height`` beside an occupancy grid is refused, as the JAX
    package refuses it, and so is an unknown pipeline type."""
    config = _config("q8")
    ds = get_dataset(config["dataset"], SCENE, device="cpu")
    nerf = atmonr_tpu_torch.load_config("configs/nerf.json")["pipeline"]
    assert isinstance(get_pipeline(nerf, ds, device="cpu"), atmonr_tpu_torch.NeRFPipeline)
    no_occ = {k: v for k, v in config["pipeline"].items() if k != "occupancy"}
    pipe = get_pipeline(no_occ, ds, device="cpu")
    assert pipe.occ_cfg is None and "occ" not in pipe.state_dict()
    tall = dict(no_occ, include_height=True, point_preprocessor=None)
    assert get_pipeline(tall, ds, device="cpu").pos_cfg.n_dims == 4
    with pytest.raises(ValueError, match="include_height"):
        get_pipeline(dict(tall, occupancy=config["pipeline"]["occupancy"]), ds, device="cpu")
    with pytest.raises(NotImplementedError, match="known types"):
        get_pipeline(dict(nerf, type="Mip-NeRF"), ds, device="cpu")


def test_load_config_matches_jax():
    from atmonr_tpu.utils.config import load_config as jax_load_config

    path = "configs/instant_ngp_tpu_occ13.json"
    assert atmonr_tpu_torch.load_config(path) == jax_load_config(path)


def test_import_leaves_jax_out():
    """Importing the port pulls in neither jax nor atmonr_tpu / atmonr_tpu.*
    (the module names exactly: atmonr_tpu_torch shares the prefix)."""
    code = (
        "import sys, atmonr_tpu_torch\n"
        "import atmonr_tpu_torch.convert, atmonr_tpu_torch._build\n"
        "import atmonr_tpu_torch.ops.hash_gather, atmonr_tpu_torch.data.synthetic\n"
        "import atmonr_tpu_torch.ops.hash_bwd, atmonr_tpu_torch.ops.losses\n"
        "import atmonr_tpu_torch.data.batching, atmonr_tpu_torch.scripts.train\n"
        "import atmonr_tpu_torch.training.trainer, atmonr_tpu_torch.training.optim\n"
        "import atmonr_tpu_torch.training.schedules, atmonr_tpu_torch.training.metrics\n"
        "import atmonr_tpu_torch.training.checkpoint, atmonr_tpu_torch.pipelines.nerf\n"
        "bad = [m for m in sys.modules if m in ('jax', 'optax', 'atmonr_tpu')\n"
        "       or m.startswith(('jax.', 'optax.', 'atmonr_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert 'atmonr_tpu_torch.ops.hash_gather' in sys.modules\n"
        "assert 'atmonr_tpu_torch.training.trainer' in sys.modules\n"
        "assert 'atmonr_tpu_torch.pipelines.nerf' in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
