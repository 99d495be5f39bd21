"""The port's encoders, MLP, samplers, occupancy grid and compositor
against the JAX package, on the CPU.

Inputs come from numpy with fixed seeds. Where the JAX function draws from
a key, the test re-derives the same draws with ``jax.random`` and passes
them to the port as explicit tensors. Tolerances: rtol 1e-5 on float32
results (the two frameworks may order reductions differently), exact on
integer results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmonr_tpu.models import encoders as jenc
from atmonr_tpu.models import mlp as jmlp
from atmonr_tpu.ops import compositor as jcomp
from atmonr_tpu.ops import occupancy as jocc
from atmonr_tpu.ops import samplers as jsamp
from atmonr_tpu_torch import convert
from atmonr_tpu_torch.models import encoders as tenc
from atmonr_tpu_torch.models import mlp as tmlp
from atmonr_tpu_torch.ops import compositor as tcomp
from atmonr_tpu_torch.ops import occupancy as tocc
from atmonr_tpu_torch.ops import samplers as tsamp

RTOL = 1e-5
OCC = {"resolution": [8, 6, 4], "n_probe": 8, "n_fine": 6, "decay": 0.8, "floor": 0.05}


def _close(got, want, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _rays(b, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    host = {
        "origin": rng.uniform(-1, 1, (b, 3)).astype(np.float32),
        "dir": d.astype(np.float32),
        "len": rng.uniform(0.2, 1.5, b).astype(np.float32),
    }
    return (
        {k: jnp.asarray(v) for k, v in host.items()},
        {k: torch.from_numpy(v) for k, v in host.items()},
    )


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_spherical_harmonics(degree):
    v = np.random.default_rng(degree).uniform(0, 1, (50, 3)).astype(np.float32)
    _close(
        tenc.spherical_harmonics(torch.from_numpy(v), degree),
        jenc.spherical_harmonics(jnp.asarray(v), degree),
    )


def test_composite_with_nested_hash_grid():
    """The surface-branch composite: 2-D HashGrid + SH on the directions."""
    cfg = {
        "otype": "Composite",
        "nested": [
            {
                "n_dims_to_encode": 2, "otype": "HashGrid", "n_levels": 4,
                "n_features_per_level": 2, "log2_hashmap_size": 9,
                "base_resolution": 16, "per_level_scale": 1.5, "fwd_mode": "xla",
            },
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2},
        ],
    }
    jspecs, tspecs = jenc.parse_encoding_config(cfg), tenc.parse_encoding_config(cfg)
    assert tenc.composite_output_dim(tspecs, 5) == jenc.composite_output_dim(jspecs, 5)
    jparams = jenc.init_composite(jax.random.PRNGKey(0), jspecs, 5)
    tables = {0: torch.tensor(np.asarray(jparams[0]["hash_table"]))}
    x = np.random.default_rng(1).uniform(0, 1, (40, 5)).astype(np.float32)
    _close(
        tenc.apply_composite(tables, tspecs, torch.from_numpy(x)),
        jenc.apply_composite(jparams, jspecs, jnp.asarray(x)),
        atol=1e-10,
    )


def test_composite_sh_identity():
    """The direction-branch composite: SH over 3 dims + Identity of the rest."""
    cfg = {
        "otype": "Composite",
        "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2},
            {"otype": "Identity"},
        ],
    }
    jspecs, tspecs = jenc.parse_encoding_config(cfg), tenc.parse_encoding_config(cfg)
    x = np.random.default_rng(2).normal(size=(30, 18)).astype(np.float32)
    _close(
        tenc.apply_composite({}, tspecs, torch.from_numpy(x)),
        jenc.apply_composite([{}, {}], jspecs, jnp.asarray(x)),
    )


def test_frequency_encoding_waits_for_nerf():
    """The ``Frequency`` encoding is ported: its output width is JAX's (2
    sin/cos channels per frequency and dim), alone and in a composite, and
    ``apply_composite`` gives that many channels."""
    for cfg, n_in in (({"otype": "Frequency", "n_frequencies": 4}, 3),
                      ({"otype": "Composite", "nested": [
                          {"otype": "Frequency", "n_frequencies": 6, "n_dims_to_encode": 2},
                          {"otype": "Identity"}]}, 5)):
        tspecs, jspecs = tenc.parse_encoding_config(cfg), jenc.parse_encoding_config(cfg)
        width = tenc.composite_output_dim(tspecs, n_in)
        assert width == jenc.composite_output_dim(jspecs, n_in)
        assert tenc.apply_composite({}, tspecs, torch.rand(7, n_in)).shape == (7, width)


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_small_mlp_with_converted_weights(compute_dtype):
    jp = jmlp.small_mlp_init(jax.random.PRNGKey(3), in_dim=32, out_dim=16,
                             n_neurons=16, n_hidden_layers=1)
    x = np.random.default_rng(4).normal(size=(64, 32)).astype(np.float32)
    tree = {"pos_table": np.zeros((8, 2)), "pos_mlp": jp, "dir_mlp": {"layers": []},
            "surf_enc": [], "surf_mlp": {"layers": []}}
    state = convert.params_from_jax(tree)
    weights = [state[f"pos_mlp.layers.{i}.weight"] for i in range(3)]
    mod = tmlp.SmallMLP(32, 16, 16, 1, torch.Generator().manual_seed(0), torch.device("cpu"))
    for layer, w in zip(mod.layers, weights):
        assert layer.weight.shape == w.shape  # (out, in), as nn.Linear keeps it
        layer.weight.data.copy_(w)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[compute_dtype]
    want = jmlp.small_mlp_apply(jp, jnp.asarray(x), compute_dtype=jdt)
    got = mod(torch.from_numpy(x), compute_dtype=tdt)
    assert got.dtype == torch.float32
    if compute_dtype == "f32":
        _close(got.detach(), want, atol=1e-6)
    else:
        # bf16 products: both round operands and outputs to 8 mantissa
        # bits, but may round partial sums differently; 2 bf16 ulps
        _close(got.detach(), want, rtol=2 * 2**-8, atol=2 * 2**-8)


@pytest.mark.parametrize("stochastic", [False, True], ids=["mid", "jitter"])
def test_sample_uniform_bins(stochastic):
    jb, tb = _rays(17, 5)
    key = jax.random.PRNGKey(6) if stochastic else None
    jp, jz = jsamp.sample_uniform_bins(jb, 8, key=key)
    t_in_bin = None
    if stochastic:
        # the draw jax makes inside sample_uniform_bins, re-derived
        t_in_bin = torch.tensor(np.asarray(jax.random.uniform(key, (17, 8))))
    tp, tz = tsamp.sample_uniform_bins(tb, 8, t_in_bin)
    _close(tz, jz, rtol=0, atol=0)
    _close(tp, jp, atol=1e-6)


def test_unit_bins_match_jnp_linspace():
    for n in (3, 6, 7, 8, 10, 24, 32, 48, 64, 100, 128):
        want = np.asarray(jnp.linspace(0.0, 1.0, n + 1, dtype=jnp.float32))[:-1]
        got = tsamp._unit_bins(n, torch.float32, torch.device("cpu")).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stochastic", [False, True], ids=["mid", "jitter"])
def test_sample_piecewise(stochastic):
    jb, tb = _rays(23, 7)
    w = np.random.default_rng(8).uniform(0.0, 1.0, (23, 8)).astype(np.float32) + 0.05
    w[3] = 0.05  # a flat ray
    w[5, :4] = 0.0  # empty bins: duplicate CDF edges
    key = jax.random.PRNGKey(9) if stochastic else None
    jp, jz = jsamp.sample_piecewise(jb, jnp.asarray(w), 6, key=key)
    jitter = None
    if stochastic:
        jitter = torch.tensor(np.asarray(jax.random.uniform(key, (23, 6), maxval=1.0 / 6)))
    tp, tz = tsamp.sample_piecewise(tb, torch.from_numpy(w), 6, jitter)
    _close(tz, jz, atol=1e-6)
    _close(tp, jp, atol=1e-6)
    assert torch.all(tz[:, 1:] >= tz[:, :-1])


def _coarse_weights(b, n_c, seed):
    """Coarse compositing weights with the hard cases: a ray whose weights
    are all zero (a flat pdf of 1e-8 per bin, and fine depths that tie
    with nothing), one with a run of zero bins (CDF steps of 1e-8 / sum,
    under the ``denom < 1e-8`` guard), and one with all its mass in one bin."""
    w = np.random.default_rng(seed).uniform(0.0, 0.2, (b, n_c, 1)).astype(np.float32)
    w[2] = 0.0
    w[4, 3:7] = 0.0
    w[6] = 0.0
    w[6, 5] = 0.7
    return w


@pytest.mark.parametrize("stochastic", [False, True], ids=["mid", "draws"])
@pytest.mark.parametrize("n_fine", [6, 16])
def test_sample_pdf(n_fine, stochastic):
    """``sample_pdf`` on the same weights, depths and quantiles: depths to
    rtol 1e-6 (the cumulative sum and the division run in the same order)
    and sorted on both sides, so equal depths order the same."""
    b, n_c = 19, 10
    jb, tb = _rays(b, 20)
    w = _coarse_weights(b, n_c, 21)
    z_c = np.sort(np.random.default_rng(22).uniform(0, 1, (b, n_c)), axis=1).astype(np.float32)
    z_c *= np.asarray(tb["len"])[:, None]
    key = jax.random.PRNGKey(23) if stochastic else None
    jp, jz = jsamp.sample_pdf(jb, jnp.asarray(w), jnp.asarray(z_c), n_fine, key=key)
    u = None
    if stochastic:
        u = torch.tensor(np.asarray(jax.random.uniform(key, (b, n_fine))))
    tp, tz = tsamp.sample_pdf(tb, torch.from_numpy(w), torch.from_numpy(z_c), n_fine, u)
    assert tz.shape == (b, n_c + n_fine) and tp.shape == (b, n_c + n_fine, 3)
    _close(tz, jz, rtol=1e-6, atol=0)
    _close(tp, jp, atol=1e-6)
    assert torch.all(tz[:, 1:] >= tz[:, :-1])
    # the coarse depths are all in the merged set
    for row, zc in zip(tz.numpy(), z_c):
        assert np.isin(zc, row).all()


def test_sample_pdf_midpoints_for_any_count():
    """The deterministic quantiles ``(i + 0.5) / n`` for counts that are not
    powers of two, where a product with the rounded reciprocal would differ
    from the division in the last place: equal to eager JAX."""
    b, n_c = 5, 9
    jb, tb = _rays(b, 24)
    w = _coarse_weights(8, n_c, 25)[:b]
    z_c = np.sort(np.random.default_rng(26).uniform(0, 1, (b, n_c)), axis=1).astype(np.float32)
    for n in (3, 7, 24, 48, 100):
        _, jz = jsamp.sample_pdf(jb, jnp.asarray(w), jnp.asarray(z_c), n)
        _, tz = tsamp.sample_pdf(tb, torch.from_numpy(w), torch.from_numpy(z_c), n)
        _close(tz, jz, rtol=1e-6, atol=0)


def test_coarse_weights_come_from_render():
    """The importance sampler's coarse weights: ``render`` with unit color
    and a (B, n_c, 1) density gives (B, n_c, 1) weights equal to JAX's, to
    rtol 1e-5 plus an ulp of 1.0 (``alpha = 1 - exp(...)``)."""
    rng = np.random.default_rng(27)
    z = np.sort(rng.uniform(0, 30, (7, 12)), axis=1).astype(np.float32)
    sigma = rng.uniform(0, 0.5, (7, 12, 1)).astype(np.float32)
    _, _, jw = jcomp.render(jnp.asarray(z), jnp.ones((7, 12, 1), jnp.float32), jnp.asarray(sigma))
    _, _, tw = tcomp.render(torch.from_numpy(z), torch.ones((7, 12, 1)), torch.from_numpy(sigma))
    assert tw.shape == jw.shape == (7, 12, 1)
    _close(tw, jw, rtol=1e-5, atol=2.0**-23)


def test_rank_right_matches_compare_and_sum():
    rng = np.random.default_rng(10)
    cdf = np.sort(rng.uniform(size=(9, 7)).astype(np.float32), axis=1)
    cdf[:, 2] = cdf[:, 1]  # duplicate edges
    u = np.concatenate([rng.uniform(size=(9, 5)), cdf[:, :3]], axis=1).astype(np.float32)
    want = jsamp._rank_right(jnp.asarray(cdf), jnp.asarray(u))
    got = tsamp._rank_right(torch.from_numpy(cdf), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stochastic", [False, True], ids=["centers", "jitter"])
def test_cell_points(stochastic):
    jc = jocc.OccupancyConfig.from_options(OCC)
    tc = tocc.OccupancyConfig.from_options(OCC)
    assert tc == tocc.OccupancyConfig(**{
        k: getattr(jc, k) for k in ("resolution", "n_probe", "n_fine", "update_every",
                                    "decay", "floor")
    })
    key = jax.random.PRNGKey(11) if stochastic else None
    want = jocc.cell_points(jc, key)
    jitter = None
    if stochastic:
        jitter = torch.tensor(np.asarray(jax.random.uniform(key, (jc.num_cells, 3))))
    got = tocc.cell_points(tc, torch.device("cpu"), jitter)
    _close(got, want, rtol=0, atol=0)


def test_update_grid_and_probe_weights():
    jc = jocc.OccupancyConfig.from_options(OCC)
    tc = tocc.OccupancyConfig.from_options(OCC)
    rng = np.random.default_rng(12)
    occ = rng.uniform(0, 2, tc.resolution).astype(np.float32)
    sigma = rng.uniform(0, 2, tc.num_cells).astype(np.float32)
    jg = jocc.update_grid(jnp.asarray(occ), jnp.asarray(sigma), jc)
    tg = tocc.update_grid(torch.from_numpy(occ), torch.from_numpy(sigma), tc)
    _close(tg, jg, rtol=0, atol=0)
    u = rng.uniform(-0.1, 1.1, (13, 8, 3)).astype(np.float32)  # some outside
    _close(tocc.probe(tg, torch.from_numpy(u)), jocc.probe(jg, jnp.asarray(u)), rtol=0, atol=0)
    _close(
        tocc.probe_weights(tg, torch.from_numpy(u), tc),
        jocc.probe_weights(jg, jnp.asarray(u), jc),
    )
    np.testing.assert_array_equal(tocc.init_grid(tc, torch.device("cpu")).numpy(),
                                  np.asarray(jocc.init_grid(jc)))


@pytest.mark.parametrize("n_sigma", [1, 4])
def test_render_with_surface(n_sigma):
    rng = np.random.default_rng(13 + n_sigma)
    z = np.sort(rng.uniform(0, 3, (11, 6)), axis=1).astype(np.float32)
    color = rng.uniform(0, 1, (11, 6, 4)).astype(np.float32)
    sigma = rng.uniform(0, 3, (11, 6, n_sigma)).astype(np.float32)
    surf = rng.uniform(0, 1, (11, 4)).astype(np.float32)
    want = jcomp.render_with_surface(*(jnp.asarray(a) for a in (z, color, sigma, surf)))
    got = tcomp.render_with_surface(*(torch.from_numpy(a) for a in (z, color, sigma, surf)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
