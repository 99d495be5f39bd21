"""The port's hash grid, the gather in its four table types (kernel K1's
plain version), the forward-mode resolution and the table gradient (kernel
K2's plain version) against the JAX package, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX Pallas kernels run in interpret mode, as tests/test_hash_pallas.py and
tests/test_hash_bwd.py run them.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
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


@pytest.mark.parametrize("n_dims", [2, 3, 4])
def test_corner_offsets_are_copied_to_a_device_once(n_dims):
    """``level_indices`` reads its corner offsets from one tensor a device,
    made at the first call: a CUDA graph's capture copies nothing from the
    host."""
    corners = thg._corners_on(n_dims, torch.device("cpu"))
    np.testing.assert_array_equal(corners.numpy(), thg._corner_offsets(n_dims))
    assert corners.dtype == torch.int64
    assert thg._corners_on(n_dims, torch.device("cpu")) is corners


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
    before = dict(thgo.hash_gather.launches)
    torch.testing.assert_close(
        thgo.hash_gather(q, s, x, tc), thgo.hash_gather_plain(q, s, x, tc),
        rtol=0, atol=0,
    )
    assert thgo.hash_gather.launches == before  # no kernel on the CPU


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


@pytest.mark.parametrize("mode", ["q8sr", ""])
def test_unknown_fwd_mode_raises(mode):
    with pytest.raises(ValueError, match="fwd_mode"):
        thg.HashGridConfig.from_options(dict(SMALL, fwd_mode=mode), 3)


def test_missing_fwd_mode_is_auto():
    """A config that names no mode is ``"auto"``, which is bf16."""
    tc = thg.HashGridConfig.from_options(SMALL, 3)
    assert tc.fwd_mode == jhg.HashGridConfig.from_options(SMALL, 3).fwd_mode == "auto"
    assert thg.resolve_fwd_mode(tc) == "bf16"


def test_pair_bucket_hash_raises():
    """A pair-bucket grid (``hashed_tile: "on"``) builds and, under
    ``fwd_mode`` auto, resolves to the exact gather over the bf16 table;
    what raises is a value the JAX package does not know, and a grid whose
    levels cannot hold one 64-entry bucket."""
    tc = thg.HashGridConfig.from_options(dict(SMALL, hashed_tile="on"), 3)
    jc = jhg.HashGridConfig.from_options(dict(SMALL, hashed_tile="on"), 3)
    assert tc.hashed_tile == jc.hashed_tile == "on"
    assert thg.resolve_fwd_mode(tc) == "xla_bf16"
    with pytest.raises(ValueError, match="hashed_tile"):
        thg.HashGridConfig.from_options(dict(SMALL, hashed_tile="auto"), 3)
    tiny = thg.HashGridConfig.from_options(dict(SMALL, log2_hashmap_size=5, hashed_tile="on"), 3)
    level = next(lv for lv in range(tiny.n_levels) if not tiny.level_is_dense(lv))
    with pytest.raises(ValueError, match="64-entry"):
        thg.level_indices(torch.rand(4, 3), tiny, level)


# the pair-bucket grids: the small one (2 of 4 levels hashed) and the
# _pb configs' encoding with its tables cut to 2^12 (11 of 16 hashed)
PAIR_BUCKET = {
    "small": dict(SMALL, hashed_tile="on"),
    "pb_config": dict(FLAGSHIP, log2_hashmap_size=12, hashed_tile="on"),
}


@pytest.mark.parametrize("name", sorted(PAIR_BUCKET))
@pytest.mark.parametrize("n_dims", [2, 3])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.2, 1.2)], ids=["unit", "beyond"])
def test_pair_bucket_level_indices_match_jax(name, n_dims, lo, hi):
    """``_use_hashed_tiles`` level by level (3-D hashed levels only), and the
    window-hash indices and weights of ``level_indices``, equal JAX's."""
    jc, tc = _cfgs(PAIR_BUCKET[name], n_dims, "auto")
    x = _points(400, n_dims, 40, lo, hi)
    tiled = [thg._use_hashed_tiles(tc, lv) for lv in range(tc.n_levels)]
    assert tiled == [jhg._use_hashed_tiles(jc, lv) for lv in range(jc.n_levels)]
    assert any(tiled) == (n_dims == 3)
    for level in range(tc.n_levels):
        j_idx, j_w = jhg.level_indices(jnp.asarray(x), jc, level)
        t_idx, t_w = thg.level_indices(torch.from_numpy(x), tc, level)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx), err_msg=str(level))
        np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w), err_msg=str(level))
        assert int(t_idx.max()) < tc.level_sizes[level]


@pytest.mark.parametrize("name", sorted(PAIR_BUCKET))
@pytest.mark.parametrize("mode", ["xla", "auto"])
def test_pair_bucket_encode_and_gradient_match_jax(name, mode):
    """``hash_encode`` of a 3-D pair-bucket grid against JAX's, which on the
    CPU takes ``_hashed_tiled_level`` (one bucket row per point and level,
    separable contractions) for the hashed levels: within 1e-6 of max|out|
    (float32 sums in another order). ``"auto"`` is the exact gather over the
    bf16-rounded table, as JAX's TPU dispatch computes it for these grids.
    The table gradient against ``jax.grad`` (JAX's sorted VJP over the same
    window indices): within 1e-6 of its largest value."""
    jc, tc = _cfgs(PAIR_BUCKET[name], 3, mode)
    table = _table(jc, 41) * 1e3
    x = _points(300, 3, 42)
    g = _cotangent(300, jc, 43)
    jtable = table
    if mode == "auto":
        jtable = np.asarray(jnp.asarray(table).astype(jnp.bfloat16).astype(jnp.float32))
    jx = jc if mode == "xla" else jhg.HashGridConfig.from_options(
        dict(PAIR_BUCKET[name], fwd_mode="xla"), 3)
    want = np.asarray(jhg.hash_encode(jnp.asarray(jtable), jnp.asarray(x), jx))
    t_t = torch.from_numpy(table).requires_grad_()
    got = thg.hash_encode(t_t, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    (t_dt,) = torch.autograd.grad(got, t_t, torch.from_numpy(g))

    def f(t):
        return jnp.sum(jhg.hash_encode(t, jnp.asarray(x), jx) * jnp.asarray(g))

    j_dt = np.asarray(jax.grad(f)(jnp.asarray(jtable)))
    assert np.abs(j_dt).max() > 0
    np.testing.assert_allclose(t_dt.numpy(), j_dt, rtol=0, atol=1e-6 * np.abs(j_dt).max())


@pytest.mark.parametrize("mode", thg.FWD_MODES)
@pytest.mark.parametrize("n_dims", [2, 3])
def test_resolve_fwd_mode_of_a_pair_bucket_grid(mode, n_dims):
    """JAX's ``_fwd_dispatch`` keeps ``hashed_tile`` grids out of Pallas: auto
    and bf16 read the bf16 table with the XLA gather, every other mode the
    f32 table."""
    opts = dict(PAIR_BUCKET["pb_config"], fwd_mode=mode)
    jc = jhg.HashGridConfig.from_options(opts, n_dims)
    got = thg.resolve_fwd_mode(thg.HashGridConfig.from_options(opts, n_dims))
    assert got == ("xla_bf16" if mode in ("auto", "bf16") else "xla")
    assert {"xla": "f32", "xla_bf16": "bf16"}[got] == _jax_tpu_dispatch_class(jc)


def test_kernels_refuse_a_pair_bucket_grid():
    """K1 and K2 index per cell; on a pair-bucket grid that would be another
    model, so both wrappers raise (before any device dispatch)."""
    tc = thg.HashGridConfig.from_options(dict(PAIR_BUCKET["small"], fwd_mode="bf16"), 3)
    x = torch.rand(16, 3)
    table = torch.zeros((tc.total_params, 2))
    with pytest.raises(ValueError, match="hashed_tile"):
        thgo.hash_gather(table.to(torch.bfloat16), None, x, tc)
    with pytest.raises(ValueError, match="hashed_tile"):
        thgo.hash_encode_kernel(table, x, tc, "bf16")
    with pytest.raises(ValueError, match="hashed_tile"):
        thbo.hash_bwd(x, torch.zeros((16, tc.n_output_dims)), tc)


# -- the bf16, f32 and f8 table types ----------------------------------------------


def _ulp_atol(cfg, x, feat_max):
    """``_pos_ulp_atol`` for a table whose decoded entries are at most
    ``feat_max[level]`` in size: D * 2^D * feat_max * ulp(max pos)."""
    cols = []
    for level in range(cfg.n_levels):
        pos_max = np.float32(np.abs(x).max() * cfg.level_scales[level] + 0.5)
        bound = cfg.n_dims * 2**cfg.n_dims * float(feat_max[level]) * np.spacing(pos_max)
        cols += [bound] * cfg.n_features_per_level
    return np.asarray(cols)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 1.3)], ids=["in", "out"])
@pytest.mark.parametrize("mode", ["bf16", "f32", "f8"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_kernel_mode_plain_matches_pallas_interpret(n_dims, mode, lo, hi):
    """The port's plain version of each table type against the Pallas
    kernel in that mode, in interpret mode. f32 and bf16: rtol 1e-6 plus the
    bound of one ulp of ``pos`` (the XLA:CPU FMA contraction, see
    ``_pos_ulp_atol``). f8: rtol 1e-5 / atol 1e-8 on top, as the JAX
    package's own test allows (XLA:CPU's ``exp2`` of an integer is not
    exactly a power of two, so its scale is an ulp off the port's)."""
    jc, tc = _cfgs(SMALL, n_dims, mode)
    assert thg.resolve_fwd_mode(tc) == mode
    table, x = _table(jc, 40), _points(333, n_dims, 41, lo, hi)
    want = np.asarray(jhgp.hash_encode_pallas_fwd(jnp.asarray(table), jnp.asarray(x), jc, mode))
    got = thg.hash_encode(torch.from_numpy(table), torch.from_numpy(x), tc).numpy()
    atol = _ulp_atol(tc, x, [np.abs(table).max()] * tc.n_levels)[None]
    rtol = 1e-6
    if mode == "f8":
        rtol, atol = 1e-5, atol + 1e-8
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + atol)
    if mode != "f8":
        assert np.mean(got == want) > 0.5


@pytest.mark.parametrize("n_dims", [2, 3])
def test_bf16_table_is_jax_cast_and_f32_table_is_the_master(n_dims):
    """The bf16 table is bit-equal to ``table.astype(jnp.bfloat16)`` (round
    to nearest even, as ``pack_level_table`` rounds); the f32 "table" is the
    master table itself, not a copy. Neither has scales."""
    jc, tc = _cfgs(FLAGSHIP, n_dims, "bf16")
    table = _table(jc, 42)
    table[:4, 0] = [1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8), 2.0**-133]  # ties, subnormal
    t = torch.from_numpy(table)
    got, scales = thgo.prepare_table(t, tc, "bf16")
    want = np.asarray(jnp.asarray(table).astype(jnp.bfloat16))
    assert scales is None and got.dtype == torch.bfloat16 and got.shape == t.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    same, scales = thgo.prepare_table(t, tc, "f32")
    assert scales is None and same.data_ptr() == t.data_ptr()
    with pytest.raises(ValueError, match="mode"):
        thgo.prepare_table(t, tc, "xla")


# XLA:CPU evaluates exp2 of an integer-valued float32 to within a few ulps of
# the power of two (measured: 1 ulp at 2^-20, 8 ulps at 2^-30), not exactly
_XLA_EXP2_RTOL = 16 * 2.0**-23


def _f8_oracle(table, cfg):
    """``quantize_level_f8``'s formula per level, the scale in exact
    arithmetic (float64 log2 of a float32 quotient), the cast by
    ml_dtypes (what ``jnp.astype(float8_e4m3fn)`` uses)."""
    codes, scales = [], []
    for level in range(cfg.n_levels):
        off, size = cfg.level_offsets[level], cfg.level_sizes[level]
        t = table[off : off + size]
        m = np.maximum(np.abs(t).max(), np.float32(1e-30))
        s = np.float32(2.0 ** np.ceil(np.log2(np.float64(np.float32(m / np.float32(448.0))))))
        codes.append((t / s).astype(ml_dtypes.float8_e4m3fn))
        scales.append(s)
    return np.concatenate(codes), np.asarray(scales, np.float32)


@pytest.mark.parametrize("options", [SMALL, FLAGSHIP], ids=["small", "flagship"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_f8_quantizer_matches_jax(n_dims, options):
    """Codes and scales of the one-pass f8 quantizer, per level. Bit-equal
    to the formula of ``quantize_level_f8`` evaluated exactly (``_f8_oracle``)
    and, given the port's scale, to jnp's division and cast. Against
    ``quantize_level_f8`` itself on the CPU: XLA:CPU's ``exp2`` of an integer
    is not exactly a power of two (e.g. ``exp2(-20.) = 0x1.fffffep-21``), so
    its scale is held to 16 ulps (``_XLA_EXP2_RTOL``), and the dequantized tables to rtol 1e-6 on
    at least 99.9% of the entries (an entry at a rounding boundary of
    ``t / s`` may take the neighbouring code)."""
    jc, tc = _cfgs(options, n_dims, "f8")
    table = _table(jc, 43)
    tq, ts = thgo.quantize_tables_f8(torch.from_numpy(table), tc)
    assert tq.dtype == torch.float8_e4m3fn and ts.dtype == torch.float32
    assert tq.shape == table.shape and ts.shape == (jc.n_levels,)
    oq, os_ = _f8_oracle(table, jc)
    np.testing.assert_array_equal(ts.numpy(), os_)
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), oq.view(np.uint8))
    assert np.all(np.abs(tq.float().numpy()).max(0) <= 448.0)
    for level in range(jc.n_levels):
        off, size = jc.level_offsets[level], jc.level_sizes[level]
        s = ts[level].item()
        assert np.log2(s) == np.round(np.log2(s))  # a power of two
        given = (jnp.asarray(table[off : off + size]) / s).astype(jnp.float8_e4m3fn)
        np.testing.assert_array_equal(
            tq[off : off + size].view(torch.uint8).numpy(), np.asarray(given).view(np.uint8)
        )
        jq, js = jhgp.quantize_level_f8(jnp.asarray(table), off, size)
        np.testing.assert_allclose(float(js), s, rtol=_XLA_EXP2_RTOL)
        jd = np.asarray(jq.astype(jnp.float32) * js)
        td = tq[off : off + size].float().numpy() * s
        assert np.mean(np.abs(td - jd) <= 1e-6 * np.abs(jd)) >= 0.999


@pytest.mark.parametrize("k", [0, 1, 5, 13, 20, 22, 30])
def test_f8_scale_at_a_power_of_two(k):
    """A level whose ``max|t|`` is exactly ``448 * 2^-k``: ``m / 448`` is a
    power of two, the scale is exactly ``2^-k`` and the largest code is
    +-448. One float32 step above, the scale doubles (448 must not be
    exceeded); one step below it stays. XLA:CPU's ``log2`` is not exact at
    powers of two (``log2(2^-13) = -12.999999``), so ``quantize_level_f8``
    on the CPU lands on either side there: the JAX package's scale is
    within 16 ulps of ``2^-k`` or of ``2^(1-k)``, and the port's is the one
    the formula defines."""
    _, tc = _cfgs(SMALL, 3, "f8")
    m = np.float32(448.0 * 2.0**-k)
    for peak, want in (
        (np.nextafter(m, np.float32(0)), 2.0**-k),
        (m, 2.0**-k),
        (np.nextafter(m, np.float32(np.inf)), 2.0 ** (1 - k)),
    ):
        table = _table(tc, 44) * np.float32(peak / 2e-4)  # |entries| < peak / 2
        off = tc.level_offsets[2]
        table[off + 3, 1] = -peak
        tq, ts = thgo.quantize_tables_f8(torch.from_numpy(table), tc)
        assert ts[2].item() == want, (peak, ts[2].item())
        code = tq[off + 3, 1].float().item()
        assert code == (-448.0 if want == 2.0**-k else -224.0)
        assert bool(torch.isfinite(tq.float()).all())
        _, js = jhgp.quantize_level_f8(jnp.asarray(table), off, tc.level_sizes[2])
        assert min(abs(float(js) / (2.0**-k) - 1), abs(float(js) / (2.0 ** (1 - k)) - 1)) <= _XLA_EXP2_RTOL


def test_f8_decode_matches_jax_for_every_code():
    """float8_e4m3fn -> float32 for the 254 codes that are not NaN: torch's
    cast (the plain version's decode) equals XLA's and the Pallas kernel's
    ``_decode_e4m3``."""
    codes = np.arange(256, dtype=np.uint8)
    codes = codes[(codes & 0x7F) != 0x7F]
    want = jax.lax.bitcast_convert_type(jnp.asarray(codes), jnp.float8_e4m3fn).astype(jnp.float32)
    got = torch.from_numpy(codes).view(torch.float8_e4m3fn).to(torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhgp._decode_e4m3(jnp.asarray(codes, jnp.uint32)))
    )
    assert np.signbit(got.numpy()[codes == 0x80])[0]  # -0.0 decodes to -0.0


def test_f8_cast_rounds_as_jax():
    """float32 -> float8_e4m3fn: torch's cast equals jnp's (ml_dtypes) on
    every code value, on every midpoint between neighbouring codes and one
    float32 step either side of it (round to nearest, ties to even), on the
    subnormals ``M * 2^-9``, on both zeros and on values below the smallest
    subnormal. Nothing in [-448, 448] saturates or becomes NaN."""
    codes = np.arange(0x7F, dtype=np.uint8)  # 0 .. 448
    vals = codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    mids = (vals[:-1] + vals[1:]) / 2
    pts = np.concatenate([
        vals, mids, np.nextafter(mids, np.float32(0)), np.nextafter(mids, np.float32(1e9)),
        np.float32([2.0**-10, 2.0**-11, 2.0**-12, 1e-30, 0.0]),
    ]).astype(np.float32)
    pts = np.concatenate([pts, -pts])
    want = np.asarray(jnp.asarray(pts).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = torch.from_numpy(pts).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.any((got & 0x7F) == 0x7F)
    assert got[np.flatnonzero(pts == 0)[-1]] == 0x80  # -0.0 survives


@pytest.mark.parametrize("mode", thg.KERNEL_MODES)
def test_gather_is_the_plain_version_on_cpu(mode):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; the table's dtype names the mode, and scales go with q8 and f8
    only."""
    _, tc = _cfgs(SMALL, 3, mode)
    t = torch.from_numpy(_table(tc, 45))
    x = torch.from_numpy(_points(64, 3, 46))
    prepared, scales = thgo.prepare_table(t, tc, mode)
    assert prepared.dtype == thgo.TABLE_DTYPES[mode]
    assert (scales is not None) == (mode in ("q8", "f8"))
    before = dict(thgo.hash_gather.launches)
    got = thgo.hash_gather(prepared, scales, x, tc)
    torch.testing.assert_close(got, thgo.hash_gather_plain(prepared, scales, x, tc), rtol=0, atol=0)
    assert thgo.hash_gather.launches == before and set(before) == {
        (m, d) for m in thg.KERNEL_MODES for d in (2, 3)
    }
    with pytest.raises(ValueError, match="scales"):
        thgo.hash_gather(prepared, None if scales is not None else torch.ones(4), x, tc)
    with pytest.raises(ValueError, match="table must be"):
        thgo.hash_gather(prepared.to(torch.float64), scales, x, tc)
    with pytest.raises(ValueError):
        thgo.hash_gather(prepared.to("meta"), scales, x.to("meta"), tc)


def _jax_tpu_dispatch_class(jc):
    """What ``_fwd_dispatch`` computes on its TPU branch, by its branch
    order and ``hash_gather_pallas.supported``: the table type the features
    are read at."""
    if jc.fwd_mode == "xla":
        return "f32"
    mode = "bf16" if jc.fwd_mode == "auto" else jc.fwd_mode
    if jc.hashed_tile != "on" and jhgp.supported(jc, mode):
        return mode
    return "bf16" if mode == "bf16" else "f32"


# (mode, D, F, log2 size, base resolution) -> what the port resolves to
_RESOLVE_CASES = [
    ("xla", 3, 2, 13, 16, "xla"),
    ("auto", 3, 2, 13, 16, "bf16"),
    ("auto", 2, 2, 13, 16, "bf16"),
    ("bf16", 3, 2, 15, 16, "bf16"),
    ("bf16", 3, 2, 16, 16, "bf16"),       # beyond the Pallas gate: the same numbers
    ("auto", 3, 2, 21, 16, "bf16"),       # the 2^21 reference tables
    ("bf16", 3, 4, 13, 16, "xla_bf16"),   # F = 4: the plain gather over the rounded table
    ("auto", 4, 2, 13, 16, "xla_bf16"),   # a 4-D grid
    ("f32", 3, 2, 13, 16, "f32"),
    ("f32", 2, 2, 19, 16, "f32"),         # beyond the gate: exact either way
    ("f32", 3, 4, 13, 16, "xla"),
    ("q8", 3, 2, 13, 16, "q8"),
    ("q8", 2, 2, 16, 16, "q8"),
    ("q8", 3, 2, 16, 16, "q8"),
    ("q8", 3, 2, 17, 16, "f32"),          # beyond the gate: exact f32, not quantized
    ("q8", 3, 4, 13, 16, "xla"),
    ("q8", 4, 2, 13, 16, "xla"),
    ("f8", 3, 2, 16, 16, "f8"),
    ("f8", 2, 2, 13, 16, "f8"),
    ("f8", 3, 2, 17, 16, "f32"),
    ("f8", 3, 4, 13, 16, "xla"),
]


@pytest.mark.parametrize(
    "mode,n_dims,n_feat,log2,base,want", _RESOLVE_CASES,
    ids=[f"{c[0]}-D{c[1]}-F{c[2]}-2^{c[3]}" for c in _RESOLVE_CASES],
)
def test_resolve_fwd_mode_matches_jax_dispatch(mode, n_dims, n_feat, log2, base, want):
    """``resolve_fwd_mode`` against the JAX package's TPU dispatch: the
    table type agrees with ``_fwd_dispatch``'s branch order and
    ``supported`` in every case, and the port runs its kernel wherever it
    takes the grid (2 features, D in (2, 3))."""
    opts = dict(FLAGSHIP, n_features_per_level=n_feat, log2_hashmap_size=log2,
                base_resolution=base, fwd_mode=mode)
    jc = jhg.HashGridConfig.from_options(opts, n_dims)
    tc = thg.HashGridConfig.from_options(opts, n_dims)
    got = thg.resolve_fwd_mode(tc)
    assert got == want
    table_type = {"xla": "f32", "xla_bf16": "bf16"}.get(got, got)
    assert table_type == _jax_tpu_dispatch_class(jc)
    assert (got in thg.KERNEL_MODES) == (n_feat == 2 and n_dims in (2, 3) and mode != "xla")


def test_resolve_fwd_mode_does_not_look_at_the_device(monkeypatch):
    """The resolution is the model's definition, not a fallback: the same
    for a machine with a card and one without, and ``hash_encode`` on a CPU
    tensor takes the plain version of the very mode a CUDA tensor would
    launch."""
    _, tc = _cfgs(SMALL, 3, "auto")
    seen = []
    for available in (True, False):
        monkeypatch.setattr(torch.cuda, "is_available", lambda a=available: a)
        seen.append(thg.resolve_fwd_mode(tc))
    assert seen == ["bf16", "bf16"]
    t, x = torch.from_numpy(_table(tc, 47)), torch.from_numpy(_points(32, 3, 48))
    prepared, _ = thgo.prepare_table(t, tc, "bf16")
    torch.testing.assert_close(
        thg.hash_encode(t, x, tc), thgo.hash_gather_plain(prepared, None, x, tc), rtol=0, atol=0
    )


@pytest.mark.parametrize("mode", ["q8", "f8"])
def test_quantized_mode_beyond_the_gate_is_exact_f32(mode):
    """A q8 or f8 grid with 2^17-entry levels: the JAX package's dispatch
    leaves the Pallas gate there and computes the exact f32 gather, and so
    does the port (it used to quantize at every table size). Equal to the
    JAX ``_hash_encode_impl`` to the exact path's tolerance, and far from
    the quantized result."""
    opts = dict(SMALL, log2_hashmap_size=17, base_resolution=16, n_levels=6, per_level_scale=2.0)
    jc, tc = _cfgs(opts, 3, mode)
    assert max(tc.level_sizes) == 1 << 17 and not jhgp.supported(jc, mode)
    assert thg.resolve_fwd_mode(tc) == "f32"
    table, x = _table(jc, 49), _points(200, 3, 50)
    got = thg.hash_encode(torch.from_numpy(table), torch.from_numpy(x), tc).numpy()
    want = np.asarray(jhg._hash_encode_impl(jnp.asarray(table), jnp.asarray(x), jc))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    prepared, scales = thgo.prepare_table(torch.from_numpy(table), tc, mode)
    quantized = thgo.hash_gather_plain(prepared, scales, torch.from_numpy(x), tc).numpy()
    assert np.abs(quantized - want).max() > 1e3 * np.abs(got - want).max()


@pytest.mark.parametrize("mode", ["auto", "bf16", "f32", "q8", "f8"])
def test_more_levels_than_the_kernels_take_raises_in_every_mode(mode):
    """The kernels take at most 32 levels. A grid with 33 resolves to its
    kernel mode all the same (the level count is no part of the JAX
    dispatch), and the encode and the table gradient raise: no mode turns
    to the plain gather instead."""
    opts = dict(SMALL, n_levels=33, per_level_scale=1.05, fwd_mode=mode)
    jc = jhg.HashGridConfig.from_options(opts, 3)
    tc = thg.HashGridConfig.from_options(opts, 3)
    want = "bf16" if mode == "auto" else mode
    assert thg.resolve_fwd_mode(tc) == want == _jax_tpu_dispatch_class(jc)
    table, x = torch.from_numpy(_table(tc, 56)), torch.from_numpy(_points(16, 3, 57))
    with pytest.raises(ValueError, match="<= 32 levels"):
        thg.hash_encode(table, x, tc)
    with pytest.raises(ValueError, match="<= 32 levels"):
        thbo.hash_bwd(x, torch.zeros((16, tc.n_output_dims)), tc)
    exact = thg.HashGridConfig.from_options(dict(opts, fwd_mode="xla"), 3)
    assert thg.hash_encode(table, x, exact).shape == (16, 66)


@pytest.mark.parametrize("n_dims", [2, 3])
def test_f32_grid_with_four_features_matches_pallas_interpret(n_dims):
    """An f32 grid with 4 features per level at 2^13 entries is inside the
    JAX gate: the TPU runs the Pallas f32 kernel there. The port's kernels
    take 2 features, so it resolves to the exact gather, which computes the
    same numbers: rtol 1e-6 plus the bound of one ulp of ``pos``, as for the
    2-feature f32 kernel mode."""
    opts = dict(FLAGSHIP, n_levels=4, n_features_per_level=4, fwd_mode="f32")
    jc = jhg.HashGridConfig.from_options(opts, n_dims)
    tc = thg.HashGridConfig.from_options(opts, n_dims)
    assert jhgp.supported(jc, "f32") and thg.resolve_fwd_mode(tc) == "xla"
    rng = np.random.default_rng(58)
    table = rng.uniform(-1e-4, 1e-4, (tc.total_params, 4)).astype(np.float32)
    x = _points(333, n_dims, 59, -0.3, 1.3)
    want = np.asarray(jhgp.hash_encode_pallas_fwd(jnp.asarray(table), jnp.asarray(x), jc, "f32"))
    got = thg.hash_encode(torch.from_numpy(table), torch.from_numpy(x), tc).numpy()
    atol = _ulp_atol(tc, x, [np.abs(table).max()] * tc.n_levels)[None]
    assert got.shape == want.shape == (333, 16) and np.all(np.isfinite(got))
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + atol)


def _mode_dispatch(mode):
    def dispatch(table, x, cfg, sr_noise=None, tiles=None):
        return jhgp.hash_encode_pallas_fwd(table, x, cfg, mode, sr_noise if mode == "q8" else None)

    return dispatch


@pytest.mark.parametrize("mode", ["bf16", "f32", "f8"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_kernel_mode_autograd_is_hash_bwd(n_dims, mode, monkeypatch):
    """The table gradient of every kernel mode is K2 on the saved positions,
    straight through the cast or the quantizer: equal to ``hash_bwd_plain``
    exactly on the CPU, and to ``jax.grad`` through JAX's ``hash_encode``
    with the Pallas kernel of that mode as its forward (its custom VJP reads
    the positions and the cotangent only), to 1e-5 of max|dW|. Positions
    get no gradient."""
    jc, tc = _cfgs(SMALL, n_dims, mode)
    table_np, x_np = _table(tc, 51), _points(200, n_dims, 52, -0.1, 1.1)
    g_np = _cotangent(200, tc, 53)
    table = torch.from_numpy(table_np).requires_grad_()
    x, g = torch.from_numpy(x_np), torch.from_numpy(g_np)
    want = thbo.hash_bwd_plain(x, g, tc)
    (got,) = torch.autograd.grad(thg.hash_encode(table, x, tc), table, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    monkeypatch.setattr(jhg, "_fwd_dispatch", _mode_dispatch(mode))
    j_dt = jax.grad(lambda t: jnp.sum(jhg.hash_encode(t, jnp.asarray(x_np), jc) * g_np))(
        jnp.asarray(table_np)
    )
    j_dt = np.asarray(j_dt)
    np.testing.assert_allclose(got.numpy(), j_dt, rtol=0, atol=1e-5 * np.abs(j_dt).max())
    with pytest.raises(ValueError, match="position gradient"):
        thg.hash_encode(table, x.clone().requires_grad_(), tc)


def test_bf16_plain_gather_has_the_f32_table_gradient():
    """``"xla_bf16"`` (a bf16 grid the kernel does not take, here F = 4):
    the features of the bf16-rounded table, as the JAX package's fallback
    gathers them, and the exact float32 table gradient straight through the
    cast."""
    opts = dict(SMALL, n_features_per_level=4, fwd_mode="bf16")
    jc, tc = jhg.HashGridConfig.from_options(opts, 3), thg.HashGridConfig.from_options(opts, 3)
    assert thg.resolve_fwd_mode(tc) == "xla_bf16"
    rng = np.random.default_rng(54)
    table_np = rng.uniform(-1e-4, 1e-4, (tc.total_params, 4)).astype(np.float32)
    x_np, g_np = _points(100, 3, 55), rng.normal(size=(100, 16)).astype(np.float32)
    table = torch.from_numpy(table_np).requires_grad_()
    out = thg.hash_encode(table, torch.from_numpy(x_np), tc)
    want = jhg._hash_encode_impl(jnp.asarray(table_np).astype(jnp.bfloat16), jnp.asarray(x_np), jc)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-10)
    (got,) = torch.autograd.grad(out, table, torch.from_numpy(g_np))
    xla = thg.HashGridConfig.from_options(dict(opts, fwd_mode="xla"), 3)
    (exact,) = torch.autograd.grad(
        thg.hash_encode(table, torch.from_numpy(x_np), xla), table, torch.from_numpy(g_np)
    )
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, exact, rtol=0, atol=0)
