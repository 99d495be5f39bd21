"""The port's hash grid, q8 gather (kernel K1's plain version) and table
gradient (kernel K2's plain version) against the JAX package, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX Pallas kernels run in interpret mode, as tests/test_hash_pallas.py and
tests/test_hash_bwd.py run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmonr_tpu.models import hash_grid as jhg
from atmonr_tpu.ops import hash_bwd_pallas as jhbp
from atmonr_tpu.ops import hash_gather_pallas as jhgp
from atmonr_tpu_torch.models import hash_grid as thg
from atmonr_tpu_torch.ops import hash_bwd as thbo
from atmonr_tpu_torch.ops import hash_gather as thgo

# small grids mixing dense and hashed levels (4 levels, 2^9 entries; the
# 2-D grid starts finer so that it has hashed levels too)
SMALL = {
    "n_levels": 4,
    "n_features_per_level": 2,
    "log2_hashmap_size": 9,
    "base_resolution": 4,
    "per_level_scale": 1.5,
}
SMALL_2D = dict(SMALL, base_resolution=16)
# the flagship's encodings (configs/instant_ngp_tpu_occ13.json)
FLAGSHIP = {
    "n_levels": 16,
    "n_features_per_level": 2,
    "log2_hashmap_size": 13,
    "base_resolution": 16,
    "per_level_scale": 1.3819,
}
FIELDS = (
    "hashmap_size", "level_scales", "level_resolutions", "level_sizes",
    "level_offsets", "total_params", "n_output_dims",
)


def _cfgs(options, n_dims, mode):
    if options is SMALL and n_dims == 2:
        options = SMALL_2D
    opts = dict(options, fwd_mode=mode)
    return (
        jhg.HashGridConfig.from_options(opts, n_dims),
        thg.HashGridConfig.from_options(opts, n_dims),
    )


def _table(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1e-4, 1e-4, (cfg.total_params, 2)).astype(np.float32)


def _points(n, n_dims, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, n_dims)).astype(np.float32)


@pytest.mark.parametrize("options", [SMALL, FLAGSHIP], ids=["small", "flagship"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_config_fields_match_jax(options, n_dims):
    jc, tc = _cfgs(options, n_dims, "q8")
    for name in FIELDS:
        assert getattr(tc, name) == getattr(jc, name), name
    for level in range(jc.n_levels):
        assert tc.level_is_dense(level) == jc.level_is_dense(level)


def test_flagship_grid_shape():
    """The numbers the kernel's source note and PERF.md use."""
    _, pos = _cfgs(FLAGSHIP, 3, "q8")
    _, surf = _cfgs(FLAGSHIP, 2, "q8")
    assert pos.total_params == 126976 and surf.total_params == 95592
    assert [pos.level_is_dense(lv) for lv in range(16)] == [True] + [False] * 15
    assert [surf.level_is_dense(lv) for lv in range(16)] == [True] * 6 + [False] * 10


@pytest.mark.parametrize("n_dims", [2, 3])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 1.5)], ids=["in", "out"])
def test_level_indices_match_jax(n_dims, lo, hi):
    jc, tc = _cfgs(SMALL, n_dims, "xla")
    assert any(tc.level_is_dense(lv) for lv in range(4))
    assert not all(tc.level_is_dense(lv) for lv in range(4))
    x = _points(257, n_dims, 1, lo, hi)
    for level in range(jc.n_levels):
        j_idx, j_w = jhg.level_indices(jnp.asarray(x), jc, level)
        t_idx, t_w = thg.level_indices(torch.from_numpy(x), tc, level)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_dims", [2, 3])
def test_exact_encode_matches_jax_xla(n_dims):
    jc, tc = _cfgs(SMALL, n_dims, "xla")
    table, x = _table(jc, 2), _points(300, n_dims, 3, -0.2, 1.2)
    want = jhg.hash_encode(jnp.asarray(table), jnp.asarray(x), jc)
    got = thg.hash_encode(torch.from_numpy(table), torch.from_numpy(x), tc)
    # the corner sum runs in another order: rtol 1e-6, and atol 1e-10 (1e-6
    # of the 1e-4 table scale) for sums that cancel to near zero
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("noise", [False, True], ids=["round", "stochastic"])
@pytest.mark.parametrize("options", [SMALL, FLAGSHIP], ids=["small", "flagship"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_quantizer_matches_jax_exactly(n_dims, options, noise):
    """Each level slice of the one-pass table quantizer equals JAX's
    ``quantize_level_q8`` on that level, exactly."""
    jc, tc = _cfgs(options, n_dims, "q8")
    table = _table(jc, 4)
    u = np.random.default_rng(5).uniform(size=table.shape).astype(np.float32)
    tq, ts = thgo.quantize_tables_q8(
        torch.from_numpy(table), tc, torch.from_numpy(u) if noise else None
    )
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    for level in range(jc.n_levels):
        off, size = jc.level_offsets[level], jc.level_sizes[level]
        jq, js = jhgp.quantize_level_q8(
            jnp.asarray(table), off, size, jnp.asarray(u) if noise else None
        )
        np.testing.assert_array_equal(tq[off : off + size].numpy(), np.asarray(jq))
        assert ts[level].item() == float(js)


def _pos_ulp_atol(cfg, x, scales):
    """Per output column: how far one ulp of ``pos = x*scale + 0.5`` can move
    a q8 output, D * 2^D * 127 * s * ulp(max pos).

    XLA:CPU contracts ``x*scale + 0.5`` (and the corner accumulation) into
    fused multiply-adds inside the interpret-mode kernel; the port rounds
    each op, as the CUDA kernel does. A one-ulp change of pos moves each
    frac by at most ulp(pos), each corner weight by at most that, and the
    sum of 2^D int8 features (|q| <= 127) times s by the bound above."""
    cols = []
    for level in range(cfg.n_levels):
        pos_max = np.float32(np.abs(x).max() * cfg.level_scales[level] + 0.5)
        bound = cfg.n_dims * 2**cfg.n_dims * 127 * float(scales[level]) * np.spacing(pos_max)
        cols += [bound] * cfg.n_features_per_level
    return np.asarray(cols)


@pytest.mark.parametrize("noise", [False, True], ids=["round", "stochastic"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_q8_plain_matches_pallas_interpret(n_dims, noise):
    """The same integers and scales, the same corner order: rtol 1e-6, plus
    the bound of one ulp of pos (the XLA:CPU FMA contraction, see
    ``_pos_ulp_atol``)."""
    jc, tc = _cfgs(SMALL, n_dims, "q8")
    table, x = _table(jc, 6), _points(333, n_dims, 7, -0.3, 1.3)
    u = np.random.default_rng(8).uniform(size=table.shape).astype(np.float32)
    want = jhgp.hash_encode_pallas_fwd(
        jnp.asarray(table), jnp.asarray(x), jc, "q8",
        jnp.asarray(u) if noise else None,
    )
    got = thg.hash_encode(
        torch.from_numpy(table), torch.from_numpy(x), tc,
        torch.from_numpy(u) if noise else None,
    ).numpy()
    want = np.asarray(want)
    _, scales = thgo.quantize_tables_q8(
        torch.from_numpy(table), tc, torch.from_numpy(u) if noise else None
    )
    atol = _pos_ulp_atol(tc, x, scales.numpy())
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + atol[None])
    assert np.mean(got == want) > 0.5


def test_q8_gather_is_the_plain_version_on_cpu():
    _, tc = _cfgs(SMALL, 3, "q8")
    t = torch.from_numpy(_table(tc, 9))
    x = torch.from_numpy(_points(64, 3, 10))
    q, s = thgo.quantize_tables_q8(t, tc)
    assert q.dtype == torch.int8 and s.shape == (4,)
    before = dict(thgo.hash_gather_q8.launches)
    torch.testing.assert_close(
        thgo.hash_gather_q8(q, s, x, tc), thgo.hash_gather_q8_plain(q, s, x, tc),
        rtol=0, atol=0,
    )
    assert thgo.hash_gather_q8.launches == before  # no kernel on the CPU


def _cotangent(n, cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.n_output_dims)).astype(np.float32)


def _jax_scatter(jc, x, g):
    """The dense f32 scatter the JAX package's own tests hold its backward
    kernels to (tests/test_hash_bwd.py)."""
    ref = jnp.zeros((jc.total_params, 2))
    for level in range(jc.n_levels):
        idx, w = jhg.level_indices(jnp.asarray(x), jc, level)
        vals = w[..., None] * jnp.asarray(g)[:, None, 2 * level : 2 * level + 2]
        ref = ref.at[(jc.level_offsets[level] + idx).reshape(-1)].add(vals.reshape(-1, 2))
    return np.asarray(ref)


@pytest.mark.parametrize("mode,rtol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_hash_bwd_plain_matches_pallas_interpret(n_dims, mode, rtol):
    """K2's plain version against the Pallas backward in interpret mode, on
    dense and hashed levels, positions outside [0, 1] and M not a multiple
    of the kernel's 4,096-point block. Tolerance, relative to max|dW| as in
    the JAX package's tests: 1e-5 against its f32 mode (another summation
    order), 2e-2 against its bf16 mode (bf16 operands; the port's sum is
    f32 for every mode)."""
    jc, tc = _cfgs(SMALL, n_dims, "q8")
    m = 4096 + 77
    x, g = _points(m, n_dims, 20, -0.2, 1.2), _cotangent(m, jc, 21)
    want = np.asarray(jhbp.hash_encode_pallas_bwd(jnp.asarray(x), jnp.asarray(g), jc, mode))
    got = thbo.hash_bwd_plain(torch.from_numpy(x), torch.from_numpy(g), tc).numpy()
    assert got.shape == want.shape == (tc.total_params, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 1.5)], ids=["in", "out"])
@pytest.mark.parametrize("options", [SMALL, FLAGSHIP], ids=["small", "flagship"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_hash_bwd_plain_matches_jax_scatter(n_dims, options, lo, hi):
    """Against JAX's dense scatter: the same indices and products, summed in
    another order; 1e-5 of max|dW|."""
    jc, tc = _cfgs(options, n_dims, "q8")
    x, g = _points(1500, n_dims, 22, lo, hi), _cotangent(1500, jc, 23)
    want = _jax_scatter(jc, x, g)
    got = thbo.hash_bwd_plain(torch.from_numpy(x), torch.from_numpy(g), tc).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_hash_bwd_is_the_plain_version_on_cpu():
    _, tc = _cfgs(SMALL, 3, "q8")
    x = torch.from_numpy(_points(64, 3, 24))
    g = torch.from_numpy(_cotangent(64, tc, 25))
    before = dict(thbo.hash_bwd.launches)
    torch.testing.assert_close(
        thbo.hash_bwd(x, g, tc), thbo.hash_bwd_plain(x, g, tc), rtol=0, atol=0
    )
    assert thbo.hash_bwd.launches == before  # no kernel on the CPU
    assert thbo.hash_bwd(x[:0], g[:0], tc).abs().sum() == 0


@pytest.mark.parametrize(
    "bad", ["x_dtype", "x_shape", "g_dtype", "g_shape", "features", "device"]
)
def test_hash_bwd_rejects_bad_inputs(bad):
    _, tc = _cfgs(SMALL, 3, "q8")
    x = torch.from_numpy(_points(8, 3, 26))
    g = torch.from_numpy(_cotangent(8, tc, 27))
    if bad == "x_dtype":
        x = x.double()
    elif bad == "x_shape":
        x = x[:, :2]
    elif bad == "g_dtype":
        g = g.to(torch.bfloat16)
    elif bad == "g_shape":
        g = g[:, :-2]
    elif bad == "features":
        tc = thg.HashGridConfig.from_options(
            dict(SMALL, fwd_mode="xla", n_features_per_level=4), 3
        )
    elif bad == "device":
        x = x.to("meta")
    with pytest.raises(ValueError):
        thbo.hash_bwd(x, g, tc)


@pytest.mark.parametrize("n_dims", [2, 3])
def test_q8_autograd_is_hash_bwd(n_dims):
    """The q8 encode's table gradient is K2 on the saved positions, straight
    through the quantizer: equal to ``hash_bwd_plain`` exactly on the CPU,
    the same with and without stochastic-rounding noise, and the noise and
    the positions get no gradient."""
    _, tc = _cfgs(SMALL, n_dims, "q8")
    table = torch.from_numpy(_table(tc, 30)).requires_grad_()
    x = torch.from_numpy(_points(200, n_dims, 31, -0.1, 1.1))
    g = torch.from_numpy(_cotangent(200, tc, 32))
    u = torch.from_numpy(np.random.default_rng(33).uniform(size=table.shape).astype(np.float32))
    want = thbo.hash_bwd_plain(x, g, tc)
    for noise in (None, u):
        out = thg.hash_encode(table, x, tc, noise)
        (got,) = torch.autograd.grad(out, table, g)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(want.abs().max()) > 0


def test_q8_encode_refuses_position_gradient():
    """The JAX pipeline passes ``compute_dx=False``; the q8 encode of the
    port has no position gradient and says so."""
    _, tc = _cfgs(SMALL, 3, "q8")
    t = torch.from_numpy(_table(tc, 11)).requires_grad_()
    x = torch.from_numpy(_points(8, 3, 12)).requires_grad_()
    with pytest.raises(ValueError, match="position gradient"):
        thg.hash_encode(t, x, tc)
    with torch.no_grad():  # inference never asks
        assert thg.hash_encode(t, x, tc).shape == (8, 8)


@pytest.mark.parametrize("n_dims", [2, 3])
def test_exact_path_gradients_match_jax(n_dims):
    """Plain autograd through the ``"xla"`` path against ``jax.grad`` of
    JAX's ``hash_encode`` (custom VJP; on the CPU its exact f32 scatter):
    the table gradient to 1e-5 of its largest value, and the position
    gradient (``compute_dx=True``) to rtol 1e-4 plus 1e-5 of its largest
    value (differences of O(1e-4) features times scales up to 13.5; XLA sums
    the corners in another order)."""
    jc, tc = _cfgs(SMALL, n_dims, "xla")
    table, x = _table(jc, 34) * 1e4, _points(150, n_dims, 35, 0.02, 0.98)
    g = _cotangent(150, jc, 36)

    def f(t, p):
        return jnp.sum(jhg.hash_encode(t, p, jc, True) * jnp.asarray(g))

    j_dt, j_dx = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    t_t = torch.from_numpy(table).requires_grad_()
    t_x = torch.from_numpy(x).requires_grad_()
    out = thg.hash_encode(t_t, t_x, tc)
    t_dt, t_dx = torch.autograd.grad(out, (t_t, t_x), torch.from_numpy(g))
    j_dt, j_dx = np.asarray(j_dt), np.asarray(j_dx)
    np.testing.assert_allclose(t_dt.numpy(), j_dt, rtol=0, atol=1e-5 * np.abs(j_dt).max())
    np.testing.assert_allclose(t_dx.numpy(), j_dx, rtol=1e-4, atol=1e-5 * np.abs(j_dx).max())
    assert np.abs(j_dx).max() > 0


@pytest.mark.parametrize("mode", thg.BWD_MODES)
def test_every_jax_bwd_mode_is_accepted(mode):
    """One f32 gradient for every ``bwd_mode`` the JAX config accepts."""
    jc, tc = _cfgs(dict(SMALL, bwd_mode=mode), 3, "q8")
    assert tc.bwd_mode == jc.bwd_mode == mode


def test_unknown_bwd_mode_raises():
    with pytest.raises(ValueError, match="bwd_mode"):
        thg.HashGridConfig.from_options(dict(SMALL, fwd_mode="q8", bwd_mode="f16"), 3)


@pytest.mark.parametrize("mode", ["auto", "bf16", "f32", "f8", "q8sr", ""])
def test_unknown_fwd_mode_raises(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thg.HashGridConfig.from_options(dict(SMALL, fwd_mode=mode), 3)


def test_missing_fwd_mode_is_auto_and_raises():
    with pytest.raises(NotImplementedError, match="'auto'"):
        thg.HashGridConfig.from_options(SMALL, 3)


def test_pair_bucket_hash_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thg.HashGridConfig.from_options(dict(SMALL, fwd_mode="q8", hashed_tile="on"), 3)
