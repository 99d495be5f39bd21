"""The port's hierarchical NeRF pipeline against the torch goldens and the JAX
package, on the CPU: the frequency encoding, AtmoNeRF, ``append_heights``,
``NeRFPipeline`` (forward, loss, gradients, extraction; with the height
channel too), two ``Trainer`` steps against ``optax.adam``, resume, and the
train and extract CLIs.

The small config is ``configs/nerf.json`` cut to 8 coarse and 16 fine samples
and 32-wide MLPs (``L_x`` [14, 14, 10] and ``L_d`` 4 as shipped) on the
synthetic granule of ``tests/test_torch_pipeline.py``. Both packages get the
same parameters (``convert.params_from_jax``) and the same draws, made from
JAX keys as JAX's forward splits them (``_jax_draws``). The "horizontal"
preprocessor and ``append_heights`` run in float32 on both sides, and their
transcendentals differ by ulps between XLA:CPU and torch: ~1.5 m in altitude,
which the frequencies up to 2^13 pi turn into visible differences. So one
float64 host function of each is shared (``_shared``): both packages take
its value, and each differentiates its own float32 formula (the fine samples
carry the coarse weights' gradient through these functions).
"""

import copy
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import atmonr_tpu_torch
from atmonr_tpu.geo import wgs84 as jwgs84
from atmonr_tpu.models import encoders as jenc
from atmonr_tpu.models import mlp as jmlp
from atmonr_tpu.ops import samplers as jsamp
from atmonr_tpu.pipelines import nerf as jnerf
from atmonr_tpu.training import schedules as jschedules
from atmonr_tpu_torch import NeRFPipeline, Trainer, convert, get_dataset, get_pipeline
from atmonr_tpu_torch.models import encoders as tenc
from atmonr_tpu_torch.models import mlp as tmlp
from atmonr_tpu_torch.ops import samplers as tsamp
from atmonr_tpu_torch.pipelines import nerf as tnerf
from atmonr_tpu_torch.scripts import extract as extract_cli
from atmonr_tpu_torch.scripts import train as train_cli
from atmonr_tpu_torch.training import checkpoint as tckpt
from test_torch_pipeline import N_RAYS, SCENE, _host_preprocess, _jax_dataset, _port_dataset
from test_torch_train import _adam_state, _jax_loss_and_grads, _t, _worst

REPO = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "golden"
G_PIPE = np.load(GOLDEN / "nerf_pipeline.npz")
G_MLP = np.load(GOLDEN / "nerf_mlp.npz")
# tests/test_nerf_parity.py's config: no preprocessor, tiny encodings
GOLDEN_CONFIG = {
    "type": "NeRF", "include_height": False, "point_preprocessor": None, "num_bands": 4,
    "ray_origin_height": 20000, "sampler": {"N_c": 8, "N_f": 16},
    "encoder": {"L_x": [5, 5, 4], "L_d": 2}, "mlp_hidden_dim": 32,
}


class _MockDataset:
    scale = float(G_PIPE["scale"])
    offset = np.zeros(3)
    config = {"ray_origin_height": 20000}

    def get_point_preprocessor(self, kind):
        raise NotImplementedError(kind)


def _nerf_config(include_height: bool = False) -> dict:
    """``configs/nerf.json`` at a small size; with ``include_height`` the
    height channel, no preprocessor, and a 4th ``L_x`` entry of 10."""
    config = atmonr_tpu_torch.load_config(REPO / "configs" / "nerf.json")
    pipe = config["pipeline"]
    pipe["sampler"] = {"N_c": 8, "N_f": 16}
    pipe["mlp_hidden_dim"] = 32
    if include_height:
        pipe.update(include_height=True, point_preprocessor=None)
        pipe["encoder"]["L_x"] = pipe["encoder"]["L_x"] + [10]
    return config


def _jax_draws(key, b: int, cfg: dict) -> dict:
    """The draws JAX's stochastic NeRF forward makes from ``key``, under the
    port's names: ``kc, kf = split(key)``, then per pass ``(sample, noise) =
    split(k)``."""
    n_c, n_f = cfg["sampler"]["N_c"], cfg["sampler"]["N_f"]
    kc, kf = jax.random.split(key)
    kcs, kcn = jax.random.split(kc)
    kfs, kfn = jax.random.split(kf)
    draws = {
        "coarse_bins": jax.random.uniform(kcs, (b, n_c)),
        "coarse_noise": jax.random.normal(kcn, (b * n_c, 1)),
        "fine_u": jax.random.uniform(kfs, (b, n_f)),
        "fine_noise": jax.random.normal(kfn, (b * (n_c + n_f), cfg["num_bands"])),
    }
    return {k: _t(v) for k, v in draws.items()}


def _shared(host_fn, jax_fn, torch_fn, out_dims):
    """One float64 host function of float32 points (..., D) -> (...,
    ``out_dims``) for both packages: its value on both sides, each package's
    own float32 ``jax_fn`` / ``torch_fn`` for the derivative."""

    @jax.custom_jvp
    def jf(p):
        shape = jax.ShapeDtypeStruct(p.shape[:-1] + (out_dims,), jnp.float32)
        return jax.pure_callback(host_fn, shape, p)

    @jf.defjvp
    def _jvp(primals, tangents):
        (p,), (t,) = primals, tangents
        _, dt = jax.jvp(jax_fn, (p,), (t,))
        return jf(p), dt

    def tf(p):
        own = torch_fn(p)
        return own + (torch.from_numpy(host_fn(p.detach().numpy())) - own).detach()

    return jf, tf


def _host_heights(scale, offset, ray_origin_height):
    def heights(pts):
        xyz = np.asarray(pts, np.float64) * scale + np.asarray(offset, np.float64)
        _, _, alt = jwgs84.cartesian_to_horizontal(xyz[..., 0], xyz[..., 1], xyz[..., 2], xp=np)
        return np.concatenate([pts, (alt / ray_origin_height)[..., None]], -1).astype(np.float32)

    return heights


def _share_functions(mp, jpipe, tpipe, jds):
    """The shared float64 preprocessor, or, with the height channel, the
    shared ``append_heights`` (patched into both pipeline modules)."""
    if jpipe.point_preprocessor:
        jpipe.point_preprocessor, tpipe.point_preprocessor = _shared(
            _host_preprocess(jds.scene_transform), jpipe.point_preprocessor,
            tpipe.point_preprocessor, 3)
    if jpipe.config["include_height"]:
        args = (jpipe.ray_origin_height, jpipe.scale, jpipe.offset)
        jf, tf = _shared(
            _host_heights(jpipe.scale, jpipe.offset, jpipe.ray_origin_height),
            lambda p: jsamp.append_heights(p, *args), lambda p: tsamp.append_heights(p, *args), 4)
        mp.setattr(jnerf, "append_heights", lambda p, *a: jf(p))
        mp.setattr(tnerf, "append_heights", lambda p, *a: tf(p))


def _close(got, want, rtol, atol_of_max):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_of_max * np.abs(want).max())


# -- the frequency encoding ------------------------------------------------------


@pytest.mark.parametrize(
    "L,shape", [(4, (300, 3)), (10, (7, 9, 4)), ([14, 14, 10], (20, 30, 3)), ([5, 5, 4, 3], (100, 4))],
    ids=["scalar", "scalar_4d", "list", "list_4d"])
def test_positional_encoding_matches_jax(L, shape):
    """Layout and values: equal, or one float32 ulp apart (sin and cos of the
    same float32 argument round differently in XLA:CPU and torch)."""
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jenc.positional_encoding(jnp.asarray(x), L))
    got = tenc.positional_encoding(torch.from_numpy(x), L).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_frequency_composite_matches_jax():
    """A composite of ``Frequency`` (4 frequencies over 3 dims) and
    ``Identity``: width and values as JAX's, within one ulp."""
    cfg = {"otype": "Composite", "nested": [
        {"otype": "Frequency", "n_frequencies": 4, "n_dims_to_encode": 3}, {"otype": "Identity"}]}
    x = np.random.default_rng(1).uniform(0, 1, (64, 5)).astype(np.float32)
    jspecs, tspecs = jenc.parse_encoding_config(cfg), tenc.parse_encoding_config(cfg)
    assert tenc.composite_output_dim(tspecs, 5) == jenc.composite_output_dim(jspecs, 5) == 26
    want = np.asarray(jenc.apply_composite([{}, {}], jspecs, jnp.asarray(x)))
    got = tenc.apply_composite({}, tspecs, torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


# -- AtmoNeRF ----------------------------------------------------------------------


def _golden_mlp() -> tmlp.AtmoNeRF:
    hidden = G_MLP["w_fc1_weight"].shape[0]
    mlp = tmlp.AtmoNeRF(int(G_MLP["pos_channels"]), int(G_MLP["dir_channels"]), 4, 4, hidden,
                        torch.Generator().manual_seed(0), torch.device("cpu"))
    with torch.no_grad():
        for i in range(1, 12):
            layer = getattr(mlp, f"fc{i}")
            layer.weight.copy_(torch.from_numpy(G_MLP[f"w_fc{i}_weight"]))
            layer.bias.copy_(torch.from_numpy(G_MLP[f"w_fc{i}_bias"]))
    return mlp


def test_atmonerf_matches_the_golden():
    """``tests/golden/nerf_mlp.npz`` at ``tests/test_mlp.py``'s tolerances."""
    mlp = _golden_mlp()
    x = torch.from_numpy(G_MLP["x"])
    with torch.no_grad():
        color, sigma = mlp(x)
        _, sigma_pos = mlp.forward_pos_only(x[:, : int(G_MLP["pos_channels"])])
    np.testing.assert_allclose(color.numpy(), G_MLP["color"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), G_MLP["sigma"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sigma_pos.numpy(), G_MLP["sigma_pos"], rtol=1e-4, atol=1e-6)


def test_atmonerf_matches_jax_and_takes_noise_before_the_relu():
    """JAX-initialized layers through ``convert``: forward to rtol 1e-5 (+1e-6
    of the largest value); noise draws shift sigma before its ReLU exactly as
    JAX's ``noise_key`` draws do."""
    coarse, fine = jmlp.get_nerf_models(jax.random.PRNGKey(5), 32, 4, [5, 5, 4], 2, False)
    state = convert.params_from_jax({"coarse": coarse, "fine": fine})
    tc, tf = tmlp.get_nerf_models(32, 4, [5, 5, 4], 2, False, torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    x = np.random.default_rng(2).normal(size=(50, 40)).astype(np.float32)
    k = jax.random.PRNGKey(6)
    for name, jp, tp, vol in (("coarse", coarse, tc, 1), ("fine", fine, tf, 4)):
        with torch.no_grad():
            for key, v in state.items():
                if key.startswith(name + "."):
                    tp.get_parameter(key[len(name) + 1:]).copy_(v)
            noise = _t(jax.random.normal(k, (50, vol)))
            for nk, nt in ((None, None), (k, noise)):
                jc, js = jmlp.atmonerf_apply(jp, jnp.asarray(x), noise_key=nk)
                tcol, tsig = tp(torch.from_numpy(x), nt)
                _close(tcol, jc, 1e-5, 1e-6)
                _close(tsig, js, 1e-5, 1e-6)
            assert not torch.equal(tp(torch.from_numpy(x))[1], tsig)


def test_nerf_models_shapes_and_init():
    """Layer shapes of ``get_nerf_models`` (``tests/test_mlp.py``'s), the
    channel counts of scalar and per-axis ``L_x`` with and without the
    height, and the init: Kaiming fan-out weights, torch-Linear biases."""
    coarse, fine = tmlp.get_nerf_models(64, 4, [5, 5, 4], 2, False,
                                        torch.Generator().manual_seed(0), torch.device("cpu"))
    assert coarse.fc1.weight.shape == (64, 28) and coarse.fc9.weight.shape == (65, 64)
    assert fine.fc9.weight.shape == (68, 64) and fine.fc10.weight.shape == (32, 76)
    assert fine.fc11.weight.shape == (4, 32)
    for args in ((10, 4, False), (10, 4, True), ([14, 14, 10], 4, False), ([5, 5, 4, 3], 2, True)):
        assert tmlp.atmonerf_channel_counts(*args) == jmlp.atmonerf_channel_counts(*args)
    with pytest.raises(ValueError, match="one count per axis"):
        tmlp.atmonerf_channel_counts([5, 5, 4], 2, True)
    w, b = tmlp.linear_init(512, 300, torch.Generator().manual_seed(1), torch.device("cpu"))
    assert abs(float(w.std()) / (2.0 / 512) ** 0.5 - 1) < 0.02 and abs(float(w.mean())) < 1e-3
    assert float(b.abs().max()) <= 300**-0.5 and float(b.abs().max()) > 0.9 * 300**-0.5


# -- append_heights ----------------------------------------------------------------


def test_append_heights_matches_jax():
    """float64: to 1e-12 (both packages evaluate the same formula in float64).
    float32: the first three channels equal; the heights within 2 x 6 m of
    each other over the 20 km normalization (each package's float32 altitude
    solve has a ~1-6 m error floor, ``geo/wgs84.py``), and each within 6 m of
    the float64 height."""
    ds = get_dataset(_nerf_config()["dataset"], SCENE, device="cpu")
    x = np.random.default_rng(3).uniform(-1, 1, (20, 30, 3))
    args = (20000, ds.scale, ds.offset)
    with jax.enable_x64(True):
        j64 = np.asarray(jsamp.append_heights(jnp.asarray(x), *args))
    t64 = tsamp.append_heights(torch.from_numpy(x), *args).numpy()
    assert t64.shape == (20, 30, 4) and t64.dtype == np.float64
    np.testing.assert_allclose(t64, j64, rtol=0, atol=1e-12)
    x32 = x.astype(np.float32)
    j32 = np.asarray(jsamp.append_heights(jnp.asarray(x32), *args))
    t32 = tsamp.append_heights(torch.from_numpy(x32), *args).numpy()
    assert t32.dtype == np.float32
    np.testing.assert_array_equal(t32[..., :3], j32[..., :3])
    assert np.abs(t32[..., 3] - j32[..., 3]).max() <= 2 * 6.0 / 20000
    assert np.abs(t32[..., 3] - j64[..., 3]).max() <= 6.0 / 20000


# -- the pipeline against the golden -----------------------------------------------


def _golden_pipeline() -> NeRFPipeline:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # varying L_x without a preprocessor
        pipe = NeRFPipeline(copy.deepcopy(GOLDEN_CONFIG), _MockDataset(), device="cpu")
    params = {m: {f"fc{i}": {"w": G_PIPE[f"w_{m}_fc{i}_weight"], "b": G_PIPE[f"w_{m}_fc{i}_bias"]}
                  for i in range(1, 12)} for m in ("coarse", "fine")}
    pipe.load_params(convert.params_from_jax(params))
    return pipe


def _golden_batch() -> dict:
    return {"origin": _t(G_PIPE["origin"]), "dir": _t(G_PIPE["direction"]),
            "len": _t(G_PIPE["length"]), "rad": _t(G_PIPE["rad"]),
            "irgb_idx": _t(G_PIPE["irgb_idx"].astype(np.int32))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_append_heights_copies_its_offset_to_a_device_once(dtype):
    """The offset reaches the points' device once, whatever form it comes
    in (a float64 array, a tuple, a tensor): a CUDA graph's capture copies
    nothing from the host. The heights equal those of the offset cast to
    the points' dtype."""
    ds = get_dataset(_nerf_config()["dataset"], SCENE, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (7, 3))).to(dtype)
    want = tsamp.append_heights(x, 20000, ds.scale, ds.offset)
    misses = tsamp._constant.cache_info().misses
    for offset in (ds.offset, tuple(ds.offset.tolist()), torch.from_numpy(ds.offset)):
        np.testing.assert_array_equal(tsamp.append_heights(x, 20000, ds.scale, offset), want)
    assert tsamp._constant.cache_info().misses == misses
    from atmonr_tpu_torch.geo.wgs84 import cartesian_to_horizontal

    xyz = x * ds.scale + torch.as_tensor(ds.offset, dtype=dtype)
    _, _, alt = cartesian_to_horizontal(*xyz.unbind(-1), xp=torch)
    np.testing.assert_array_equal(want[:, 3], alt / 20000)


def test_pipeline_matches_the_golden():
    """``tests/golden/nerf_pipeline.npz`` (the reference's torch, deterministic
    mode): radiances, loss and all 44 gradient tensors at the tolerances of
    ``tests/test_nerf_parity.py``."""
    pipe, batch = _golden_pipeline(), _golden_batch()
    out = pipe(batch)
    tol = {"z_vals_coarse": (1e-5, 0), "z_vals_fine": (1e-4, 1e-6),
           "color_map_coarse": (5e-4, 1e-5), "color_map_fine": (5e-4, 1e-5),
           "weights_coarse": (1e-3, 1e-6), "sigma_fine": (1e-3, 1e-5)}
    for k, (rtol, atol) in tol.items():
        np.testing.assert_allclose(out[k].detach().numpy(), G_PIPE[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    loss = pipe.compute_loss(batch, out)
    np.testing.assert_allclose(float(loss), float(G_PIPE["loss"]), rtol=1e-4)
    loss.backward()
    grads = convert.grads_state(pipe)
    assert len(grads) == 44
    for mode in ("coarse", "fine"):
        for i in range(1, 12):
            for suffix in ("weight", "bias"):
                ref = G_PIPE[f"g_{mode}_fc{i}_{suffix}"]
                scale = np.abs(ref).max() + 1e-12
                np.testing.assert_allclose(
                    grads[f"{mode}.fc{i}.{suffix}"].numpy() / scale, ref / scale,
                    rtol=2e-3, atol=2e-4, err_msg=f"{mode}.fc{i}.{suffix}")


# -- the pipeline against the JAX package ----------------------------------------


@pytest.fixture(scope="module", params=["nerf_json", "include_height"])
def pair(request):
    """The JAX ``NeRFPipeline`` and the port's at identical parameters (seed-1
    JAX init): the small ``nerf.json``, with or without the height channel,
    on 48 rays of the synthetic granule, the float64 functions shared."""
    variant = request.param
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # varying L_x without a preprocessor
        config = _nerf_config(include_height=variant == "include_height")
        pcfg = config["pipeline"]
        jds = _jax_dataset(config)
        tds = _port_dataset(config["dataset"])
        idx = np.random.default_rng(6).permutation(len(tds))[:N_RAYS]
        batch = {k: v[idx] for k, v in tds.host_rays().items()}
        jpipe = jnerf.NeRFPipeline(pcfg, jds)
        tpipe = NeRFPipeline(copy.deepcopy(pcfg), tds, device="cpu")
        params = jpipe.init_params(jax.random.PRNGKey(1))
        tpipe.load_params(convert.params_from_jax(params))
        _share_functions(mp, jpipe, tpipe, jds)
        yield {"variant": variant, "jpipe": jpipe, "tpipe": tpipe, "params": params,
               "jbatch": {k: jnp.asarray(v) for k, v in batch.items()},
               "tbatch": {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
               "config": pcfg, "tds": tds, "jds": jds}


def _same_samples(jout, tout) -> np.ndarray:
    """The rays whose fine samples are bit-equal in both packages. The fine
    samples invert the CDF of the coarse weights, which differ in their
    last float32 bits; a sample that moves by an ulp moves its encoding by
    up to ~1e-3 at frequencies up to 2^13 pi. JAX runs eagerly here, op by
    op as torch rounds: under jit XLA contracts the samplers' products and
    sums into fused multiply-adds, and then few rays keep their samples."""
    return np.all(np.asarray(jout["z_vals_fine"]) == tout["z_vals_fine"].detach().numpy(), axis=1)


# outputs composited from alpha = 1 - exp(-sigma * delta), with delta the
# sample spacing in km: sigma's float32 error (~1e-6 of its largest value)
# times a spacing of up to ~10 km, plus exp's last-ulp rounding
_FROM_ALPHA = ("weights_", "color_map_")


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "draws"])
def test_forward_matches_jax(pair, stochastic):
    """Every output (``norm_heights_*`` too, with the height channel) to
    rtol 1e-5 plus 1e-6 of its largest value, plus 2e-5 of it for the
    outputs composited from alpha. The coarse outputs on every ray; the
    fine ones on the rays whose fine samples are bit-equal (every ray
    without draws, at least 3/4 of them with: a sample that moves by an ulp
    changes its encoding, ``_same_samples``), and every ray's fine depths to
    rtol 4e-6."""
    jpipe, tpipe = pair["jpipe"], pair["tpipe"]
    b = pair["tbatch"]["origin"].shape[0]
    key = jax.random.PRNGKey(2) if stochastic else None
    draws = _jax_draws(key, b, pair["config"]) if stochastic else None
    jout = jpipe.forward(pair["params"], pair["jbatch"], key=key)
    with torch.no_grad():
        tout = tpipe(pair["tbatch"], draws=draws)
    assert tout.keys() == jout.keys()
    if pair["variant"] == "include_height":
        assert tout["norm_heights_fine"].shape == (b, 24)
    same = _same_samples(jout, tout)
    assert same.all() if not stochastic else same.mean() >= 0.75, same.sum()
    for k in jout:
        rows = same if k.endswith("_fine") else np.ones(b, bool)
        atol = 1e-6 + (2e-5 if k.startswith(_FROM_ALPHA) else 0)
        want = np.asarray(jout[k])
        got = tout[k].numpy()[rows]
        np.testing.assert_allclose(got, want[rows], rtol=1e-5, atol=atol * np.abs(want).max(),
                                   err_msg=k)
    np.testing.assert_allclose(tout["z_vals_fine"].numpy(), np.asarray(jout["z_vals_fine"]),
                               rtol=4e-6)
    if stochastic:
        with torch.no_grad():
            det = tpipe(pair["tbatch"])
        assert not torch.equal(det["z_vals_fine"], tout["z_vals_fine"])


def _ray_loss(xp, results, batch, mask):
    """The pipeline's loss (coarse plus fine MSE on each ray's own band)
    over the rays in ``mask``; ``compute_loss`` when every ray is in."""
    err = 0.0
    for mode in ("coarse", "fine"):
        cmap = results[f"color_map_{mode}"]
        if xp is jnp:
            pred = jnp.take_along_axis(cmap, batch["irgb_idx"][:, None], axis=1)[:, 0]
        else:
            pred = torch.gather(cmap, 1, batch["irgb_idx"][:, None].long())[:, 0]
        err = err + (pred - batch["rad"]) ** 2
    return xp.sum(err * mask) / xp.sum(mask)


def test_loss_and_gradients_match_jax(pair):
    """One stochastic step: ``compute_loss`` to rtol 1e-5 over every ray,
    and all 44 gradients of the same loss over the rays whose fine samples
    are bit-equal (``_same_samples``) against ``jax.grad``, to rtol 1e-4
    plus 1e-5 of each tensor's largest value (the GEMMs' float32 sums run in
    another order, and the inverse CDF passes the coarse weights' gradient
    through a division by a CDF difference)."""
    jpipe, tpipe = pair["jpipe"], pair["tpipe"]
    jbatch, tbatch = pair["jbatch"], pair["tbatch"]
    b = tbatch["origin"].shape[0]
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(key, b, pair["config"])
    jout = jpipe.forward(pair["params"], jbatch, key=key)
    tpipe.zero_grad()
    tout = tpipe(tbatch, draws=draws)
    np.testing.assert_allclose(float(tpipe.compute_loss(tbatch, tout)),
                               float(jpipe.compute_loss(jbatch, jout)), rtol=1e-5)
    same = _same_samples(jout, tout)
    assert same.mean() >= 0.75, same.sum()

    def jloss(p):
        return _ray_loss(jnp, jpipe.forward(p, jbatch, key=key), jbatch, jnp.asarray(same, jnp.float32))

    jgrads = jax.grad(jloss)(pair["params"])
    _ray_loss(torch, tout, tbatch, torch.from_numpy(same).float()).backward()
    tgrads = convert.grads_state(tpipe)
    jg = convert.params_from_jax(jgrads)
    assert len(jg) == 44 and set(jg) == set(tgrads)
    worst = _worst(tgrads, jg, rtol=1e-4, atol_of_max=1e-5)
    assert max(worst.values()) <= 0, worst
    for k in jg:
        assert float(jg[k].abs().max()) > 0, k


def test_extract_matches_jax(pair):
    """The fine model's extinction at 300 points: (M, num_bands), to rtol
    1e-5 plus 1e-6 of the largest value."""
    pts = np.random.default_rng(4).uniform(-1, 1, (300, 3)).astype(np.float32)
    want = pair["jpipe"].extract(pair["params"], jnp.asarray(pts))
    got = pair["tpipe"].extract(torch.from_numpy(pts))
    assert got.shape == (300, 4) and not got.requires_grad and float(got.min()) >= 0
    _close(got, want, 1e-5, 1e-6)


# -- training ----------------------------------------------------------------------

K_STEPS = 2


def _trainer_config(**over) -> dict:
    cfg = dict(_nerf_config()["trainer"], batch_size=N_RAYS, num_iters=40, print_frequency=2)
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def training_run(tmp_path_factory):
    """``K_STEPS`` steps of the port's ``Trainer`` and of a JAX loop (the JAX
    pipeline's ``make_optimizer``: ``optax.adam`` on the JAX schedule) on the
    small ``nerf.json``, the same index vectors and draws, with the golden
    config's encodings (``L_x`` [5, 5, 4], ``L_d`` 2). At the shipped
    frequencies (up to 2^13 pi) the coarse MLP's gradient through the fine
    samples' positions is chaotic in float32: a few rays whose samples move
    by an ulp (``_same_samples``) put the coarse moments 1e-3 apart after
    one step, and a step later the two runs differ wholly (measured on this
    batch: relative L2 12 on ``coarse.fc9.bias``'s moments).
    ``test_loss_and_gradients_match_jax`` holds one such step on the rays
    that keep their samples."""
    config = _nerf_config()
    pcfg, tcfg = config["pipeline"], _trainer_config()
    pcfg["encoder"] = dict(GOLDEN_CONFIG["encoder"])
    jds = _jax_dataset(config)
    tds = _port_dataset(config["dataset"])
    jpipe = jnerf.NeRFPipeline(pcfg, jds)
    tpipe = get_pipeline(copy.deepcopy(pcfg), tds, device="cpu")
    params = jpipe.init_params(jax.random.PRNGKey(1))
    trainer = Trainer(tcfg, tds, tpipe, "nerf", tmp_path_factory.mktemp("nerf"), device="cpu")
    assert trainer.aux_update_every == 0 and trainer.micro_batch is None
    tpipe.load_params(convert.params_from_jax(params))
    jopt = jpipe.make_optimizer(
        tcfg["optimizer"],
        jschedules.make_lr_schedule(tcfg["scheduler"], tcfg["optimizer"], tcfg["num_iters"],
                                    trainer.steps_per_epoch))
    opt_state = jopt.init(params)
    rng = np.random.default_rng(7)
    steps = []
    with pytest.MonkeyPatch.context() as mp:
        _share_functions(mp, jpipe, tpipe, jds)
        for s in range(K_STEPS):
            idx = rng.permutation(len(tds))[:N_RAYS]
            key = jax.random.fold_in(jax.random.PRNGKey(3), s)
            jbatch = {k: jnp.asarray(v[idx]) for k, v in tds.host_rays().items()}
            jloss, jgrads = _jax_loss_and_grads(jpipe, params, jbatch, key, None)
            updates, opt_state = jopt.update(jgrads, opt_state, params)
            params = optax.apply_updates(params, updates)
            tloss = trainer.step(_t(idx), draws=_jax_draws(key, N_RAYS, pcfg))
            mu, nu = convert.moments_state(tpipe, trainer.optimizer.adamw)
            adam = _adam_state(opt_state)
            steps.append({
                "jloss": float(jloss), "tloss": float(tloss),
                "jparams": convert.params_from_jax(params),
                "tparams": {k: v.detach().clone() for k, v in tpipe.named_parameters()},
                "jmu": convert.params_from_jax(adam.mu), "jnu": convert.params_from_jax(adam.nu),
                "tmu": mu, "tnu": nu,
            })
    return {"steps": steps, "trainer": trainer}


def test_trainer_matches_jax_and_optax_adam(training_run):
    """Losses to rtol 1e-5. Adam's moments after each step to rtol 1e-4 (mu)
    and 2e-4 (nu) plus 1e-5 of each tensor's largest value (the gradients'
    tolerance, squared into nu). Parameters to rtol 1e-5 plus 1e-6 of the
    largest value: with eps 1e-8 an update is lr * m / (sqrt(v) + eps), and
    lr 5e-4 keeps the moments' differences far below the parameters'."""
    for i, s in enumerate(training_run["steps"]):
        assert np.isfinite(s["tloss"])
        np.testing.assert_allclose(s["tloss"], s["jloss"], rtol=1e-5)
        for got, want, rtol, atol in (("tmu", "jmu", 1e-4, 1e-5), ("tnu", "jnu", 2e-4, 1e-5),
                                      ("tparams", "jparams", 1e-5, 1e-6)):
            worst = _worst(s[got], s[want], rtol=rtol, atol_of_max=atol)
            assert max(worst.values()) <= 0, (i, got, worst)
    opt = training_run["trainer"].optimizer
    assert opt.count == K_STEPS and opt.max_norm is None
    for group in opt.adamw.param_groups:
        assert group["weight_decay"] == 0.0 and group["betas"] == (0.9, 0.999)
        assert group["eps"] == 1e-8


def test_optimizer_ignores_the_configs_adamw_keys():
    """``optax.adam`` takes the learning rate alone: betas, eps, weight decay
    and a clip named in the optimizer block change nothing, the warmup
    does."""
    tds = get_dataset(_nerf_config()["dataset"], SCENE, device="cpu")
    pipe = get_pipeline(_nerf_config()["pipeline"], tds, device="cpu")
    opt = pipe.make_optimizer({"lr": 1.0, "betas": [0.5, 0.5], "eps": 1e-15,
                               "weight_decay": 0.1, "clip_global_norm": 1.0, "warmup_iters": 4},
                              0.01)
    assert opt.max_norm is None and len(opt.params) == 44
    assert [opt.lr_schedule(s) for s in (0, 3, 9)] == [0.01 / 4, 0.01, 0.01]
    for group in opt.adamw.param_groups:
        assert group["weight_decay"] == 0.0 and group["betas"] == (0.9, 0.999)


def _tiny_trainer(root, name, seed=0, **over):
    config = _nerf_config()
    config["pipeline"]["mlp_hidden_dim"] = 16
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    pipe = get_pipeline(config["pipeline"], tds, device="cpu")
    return Trainer(_trainer_config(**over), tds, pipe, name, root, seed=seed, device="cpu")


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Three steps, a checkpoint, a new Trainer, ``load`` and three more,
    against a run interrupted and continued in one Trainer: parameters and
    Adam's moments equal bit for bit on the CPU; every loss finite and the
    progress scatter filled from ``color_map_fine``."""
    kw = dict(batch_size=250, num_iters=6, print_frequency=2)
    first = _tiny_trainer(tmp_path / "b", "halves", **kw)
    assert first.steps_per_epoch == 4
    for it in first.iterate(tmp_path / "b" / "out"):
        if it == 3:
            first._preempted = True
    state, epoch = tckpt.restore_checkpoint(tmp_path / "b" / "out")
    assert epoch == 1 and set(state["pipeline"]) == set(dict(first.pipeline.named_parameters()))
    second = _tiny_trainer(tmp_path / "b", "halves", seed=123, **kw)
    second.load(tmp_path / "b" / "out")
    assert second.iter_count == 3 and second.optimizer.count == 3
    second.train(tmp_path / "b" / "out")

    again = _tiny_trainer(tmp_path / "c", "again", **kw)
    for it in again.iterate(tmp_path / "c" / "out"):
        if it == 3:
            again._preempted = True
    again._preempted = False
    again.train(tmp_path / "c" / "out")
    assert again.iter_count == second.iter_count == 6
    assert bool(torch.isfinite(again.last_loss)) and float(again.pred_pixels.abs().max()) > 0
    mu_a, nu_a = convert.moments_state(again.pipeline, again.optimizer.adamw)
    mu_b, nu_b = convert.moments_state(second.pipeline, second.optimizer.adamw)
    for a, b in ((dict(again.pipeline.named_parameters()), dict(second.pipeline.named_parameters())),
                 (mu_a, mu_b), (nu_a, nu_b)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_train_and_extract_clis(tmp_path, capsys):
    """``scripts/train.py`` on a small ``nerf.json`` (two epochs, then
    ``--resume`` for a third), then ``scripts/extract.py`` restores the
    latest checkpoint and queries the voxel grid through
    ``NeRFPipeline.extract``: (N, 4) sigma, written to the netCDF."""
    config = _nerf_config()
    config["pipeline"]["mlp_hidden_dim"] = 16
    config["trainer"].update(batch_size=250, print_frequency=2)
    cfg_path = tmp_path / "nerf_small.json"
    cfg_path.write_text(json.dumps(config))
    args = ["--exp-name", "nerf", "--config-path", str(cfg_path), "--scene-filename", SCENE,
            "--data-root", str(tmp_path), "--device", "cpu"]
    train_cli.main(args + ["--num-iters", "8", "--overwrite"])
    out = tmp_path / "output" / "nerf"
    assert tckpt.latest_epoch(out) == 2
    train_cli.main(args + ["--num-iters", "12", "--resume"])
    assert tckpt.latest_epoch(out) == 3
    assert "Epoch 3/3" in capsys.readouterr().out
    run = extract_cli.main(["--exp-name", "nerf", "--coord-mode", "voxelgrid",
                            "--extract-filename", "nerf.nc", "--data-root", str(tmp_path),
                            "--device", "cpu", "--horizontal-step", "3000", "--alt-step", "1000"])
    assert run.sigma.shape == (len(run.grid), 4) and run.path.exists()
    assert np.all(np.isfinite(run.sigma)) and np.all(run.sigma >= 0)

