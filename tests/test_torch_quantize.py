"""Kernel K1p (``csrc/quantize.cu``, the q8/f8 table preparation) on the CPU:
its block geometry (``ops/kernel_plan.py::quantize_plan``), a numpy
emulation of its two launches held exactly to the JAX package's quantizers
and to the plain version, and the wrapper's CPU path. The kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``).

Inputs come from numpy with fixed seeds and go through both packages.
"""

import bisect
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread
from atmonr_tpu.models import hash_grid as jhg
from atmonr_tpu.ops import hash_gather_pallas as jhgp
from atmonr_tpu_torch.models import hash_grid as thg
from atmonr_tpu_torch.ops import hash_gather as thgo
from atmonr_tpu_torch.ops import kernel_plan as kp
from test_torch_hash_grid import _XLA_EXP2_RTOL, _f8_oracle

FLAGSHIP = {"n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 13,
            "base_resolution": 16, "per_level_scale": 1.3819}
# every shipped q8/f8 grid (the flagship's two), a 2^14 grid, and the
# largest table the q8/f8 gate lets through: 32 levels of at most 2^16 rows
GRIDS = {
    "flagship pos": (FLAGSHIP, 3),
    "flagship surface": (FLAGSHIP, 2),
    "2^14 pos": (dict(FLAGSHIP, log2_hashmap_size=14), 3),
    "gate 32 x 2^16": (dict(FLAGSHIP, n_levels=32, log2_hashmap_size=16), 3),
}
# a single block (every level in one range), 7 (ranges that straddle
# levels) and the plan's own count (132 or more at these grids)
BLOCKS = {"1 block": 1, "7 blocks": 7, "plan": kp.QUANTIZE_MAX_BLOCKS}


def _cfgs(name, mode):
    options, n_dims = GRIDS[name]
    opts = dict(options, fwd_mode=mode)
    return (jhg.HashGridConfig.from_options(opts, n_dims),
            thg.HashGridConfig.from_options(opts, n_dims))


@functools.cache
def _inputs(name):
    _, tc = _cfgs(name, "q8")
    rng = np.random.default_rng(40 + list(GRIDS).index(name))
    table = rng.uniform(-1e-4, 1e-4, (tc.total_params, 2)).astype(np.float32)
    noise = rng.uniform(size=table.shape).astype(np.float32)
    return table, noise


def _level_scale(m: np.float32, mode: str) -> np.float32:
    """The scale of a level whose largest |t| is ``m``, as the kernel's
    ``level_scale`` computes it."""
    m = np.float32(1e-30) if m < np.float32(1e-30) else m  # a NaN stays NaN
    if mode == "q8":
        return np.float32(m / np.float32(127.0))
    f, e = np.frexp(np.float32(m / np.float32(448.0)))
    return np.float32(2.0 ** (int(e) - 1 if f == 0.5 else int(e)))


def _codes(t: np.ndarray, s: np.float32, u: np.ndarray | None, mode: str) -> np.ndarray:
    v = t / s  # float32 / float32: a true float32 division
    if mode == "f8":
        return v.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    q = np.rint(v) if u is None else np.floor(v + u)
    return np.clip(q, -127, 127).astype(np.int8).view(np.uint8)


def emulate(table: np.ndarray, noise: np.ndarray | None, cfg, mode: str,
            plan: kp.QuantizePlan) -> tuple[np.ndarray, np.ndarray]:
    """The two launches of ``csrc/quantize.cu`` in numpy, block by block, in
    ``plan``'s flat row ranges: (codes as uint8 (T, 2), scales (L,)).

    1. reduce: block b writes ``partials[b, l]``, the largest |t| of the
       rows of level l in its range as the float's bits, for each level its
       range touches, and nothing else (-1 marks an entry never written).
    2. codes: block b takes, for each level its range touches, the maximum
       over ``plan.level_blocks`` of that level's partials (each must have
       been written), the scale from it (stored by the level's first
       block, which must be the only one), then its rows' codes, each with
       the scale of its own level from the block's table of scales."""
    offs = list(cfg.level_offsets) + [cfg.total_params]
    bits = (table.view(np.uint32) & np.uint32(0x7FFFFFFF)).max(axis=1)  # of a row

    def level_of(row):
        return min(bisect.bisect_right(offs, row) - 1, cfg.n_levels - 1)

    def touched(b):
        r0, r1 = plan.block_span(b)
        return range(level_of(r0), level_of(r1 - 1) + 1)

    partials = np.full(plan.partials_shape, -1, np.int64)
    for b in range(plan.blocks):
        r0, r1 = plan.block_span(b)
        for lv in touched(b):
            lo, hi = max(r0, offs[lv]), min(r1, offs[lv + 1])
            partials[b, lv] = int(bits[lo:hi].max())

    codes = np.zeros(table.shape, np.uint8)
    scales = np.full(cfg.n_levels, np.nan, np.float32)
    stored = np.zeros(cfg.n_levels, np.int64)
    for b in range(plan.blocks):
        r0, r1 = plan.block_span(b)
        scale = {}
        for lv in touched(b):
            blocks = plan.level_blocks(offs[lv], offs[lv + 1] - offs[lv])
            parts = partials[blocks.start:blocks.stop, lv]
            assert (parts >= 0).all(), (b, lv)  # every entry read was written
            scale[lv] = _level_scale(np.uint32(parts.max()).view(np.float32), mode)
            if blocks.start == b:
                scales[lv] = scale[lv]
                stored[lv] += 1
        for lv in touched(b):
            lo, hi = max(r0, offs[lv]), min(r1, offs[lv + 1])
            u = None if noise is None else noise[lo:hi]
            codes[lo:hi] = _codes(table[lo:hi], scale[lv], u, mode)
    assert (stored == 1).all()  # each level's scale stored by exactly one block
    return codes, scales


@functools.cache
def _jax_q8(name, noise):
    """JAX's ``quantize_level_q8`` per level, as (int8 codes (T, 2), scales)."""
    jc, _ = _cfgs(name, "q8")
    table, u = _inputs(name)
    table, u = jnp.asarray(table), jnp.asarray(u) if noise else None
    codes, scales = [], []
    for level in range(jc.n_levels):
        q, s = jhgp.quantize_level_q8(table, jc.level_offsets[level], jc.level_sizes[level], u)
        codes.append(np.asarray(q).astype(np.int8))
        scales.append(np.float32(s))
    return np.concatenate(codes), np.asarray(scales, np.float32)


@pytest.mark.parametrize("blocks", BLOCKS.values(), ids=BLOCKS)
@pytest.mark.parametrize("noise", [False, True], ids=["round", "noise"])
@pytest.mark.parametrize("name", GRIDS)
def test_emulation_matches_jax_q8(name, noise, blocks):
    """The kernel's reduction and quantization, emulated in its blocks,
    equal JAX's ``quantize_level_q8`` on every level (codes and scales) and
    the plain version, exactly."""
    _, tc = _cfgs(name, "q8")
    table, u = _inputs(name)
    plan = kp.quantize_plan(tc, blocks)
    assert (plan.blocks == 1) if blocks == 1 else (plan.blocks >= min(blocks, 132))
    codes, scales = emulate(table, u if noise else None, tc, "q8", plan)
    jq, js = _jax_q8(name, noise)
    np.testing.assert_array_equal(codes.view(np.int8), jq)
    np.testing.assert_array_equal(scales, js)
    with one_torch_thread():
        pq, ps = thgo.quantize_tables_q8(torch.from_numpy(table), tc,
                                         torch.from_numpy(u) if noise else None)
    np.testing.assert_array_equal(codes.view(np.int8), pq.numpy())
    np.testing.assert_array_equal(scales, ps.numpy())


@pytest.mark.parametrize("blocks", BLOCKS.values(), ids=BLOCKS)
@pytest.mark.parametrize("name", GRIDS)
def test_emulation_matches_jax_f8(name, blocks):
    """The same for f8: bit-equal to ``quantize_level_f8``'s formula
    evaluated exactly (``_f8_oracle``), to jnp's division and cast given the
    scale, and to the plain version; ``quantize_level_f8``'s own scale is
    XLA:CPU's ``exp2(ceil(log2(.)))``, which is not exactly a power of two,
    within ``_XLA_EXP2_RTOL`` (as ``test_f8_quantizer_matches_jax``)."""
    jc, tc = _cfgs(name, "f8")
    table, _ = _inputs(name)
    codes, scales = emulate(table, None, tc, "f8", kp.quantize_plan(tc, blocks))
    oq, os_ = _f8_oracle(table, jc)
    np.testing.assert_array_equal(codes, oq.view(np.uint8))
    np.testing.assert_array_equal(scales, os_)
    jt = jnp.asarray(table)
    for level in (0, jc.n_levels // 2, jc.n_levels - 1):
        off, size = jc.level_offsets[level], jc.level_sizes[level]
        given = (jt[off:off + size] / scales[level]).astype(jnp.float8_e4m3fn)
        np.testing.assert_array_equal(codes[off:off + size], np.asarray(given).view(np.uint8))
        _, js = jhgp.quantize_level_f8(jt, off, size)
        np.testing.assert_allclose(float(js), scales[level], rtol=_XLA_EXP2_RTOL)
    with one_torch_thread():
        pq, ps = thgo.quantize_tables_f8(torch.from_numpy(table), tc)
    np.testing.assert_array_equal(codes, pq.view(torch.uint8).numpy())
    np.testing.assert_array_equal(scales, ps.numpy())


def _edge_table(tc):
    """The flagship position grid's table with four crafted levels: level 1
    all zeros (scale 1e-30 / 127); level 2 with max|t| 127 (q8 scale 1) and
    entries at exactly k + 0.5 (round half to even); level 3 with a max m
    whose q8 quotient m / (m / 127) rounds above 127, so noise lifts its
    code to 128 (clamped to 127) and -m floors to -128 (clamped to -127);
    level 4 with max 448 * 2^-20 (m / 448 a power of two: f8 scale 2^-20,
    codes +-448). Returns (table, noise, where level 3's m and -m are)."""
    table, _ = _inputs("flagship pos")
    table, noise = table.copy(), np.zeros_like(table)
    off = tc.level_offsets
    table[off[1]:off[2]] = 0.0
    table[off[2]:off[3]] *= np.float32(1e4)
    table[off[2]:off[2] + 6, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    rng = np.random.default_rng(3)
    cands = rng.uniform(1e-4, 1e-2, 4096).astype(np.float32)
    m = next(c for c in cands if c / (c / np.float32(127)) > np.float32(127))
    table[off[3]:off[4]] *= np.float32(m / 2e-4)  # |entries| < m / 2
    at = (off[3] + 5, off[3] + 9)
    table[at[0], 1], table[at[1], 0] = m, -m
    noise[at[0], 1] = np.nextafter(np.float32(1), np.float32(0))
    table[off[4] + 3, 1] = -np.float32(448.0 * 2.0**-20)
    return table, noise, at


@pytest.mark.parametrize("mode", ["q8", "q8 noise", "f8"])
def test_emulation_edge_cases(mode):
    """The crafted levels of ``_edge_table``, emulated in 7 blocks: equal to
    JAX (q8: ``quantize_level_q8``; f8: its formula) and to the plain
    version, with the values each edge case implies."""
    jc, tc = _cfgs("flagship pos", mode[:2])
    table, noise, at = _edge_table(tc)
    u = noise if mode == "q8 noise" else None
    codes, scales = emulate(table, u, tc, mode[:2], kp.quantize_plan(tc, 7))
    off = tc.level_offsets
    with one_torch_thread():
        t = torch.from_numpy(table)
        pq, ps = (thgo.quantize_tables_f8(t, tc) if mode == "f8" else
                  thgo.quantize_tables_q8(t, tc, None if u is None else torch.from_numpy(u)))
    np.testing.assert_array_equal(codes, pq.view(torch.uint8).numpy())
    np.testing.assert_array_equal(scales, ps.numpy())
    if mode == "f8":
        oq, os_ = _f8_oracle(table, jc)
        np.testing.assert_array_equal(codes, oq.view(np.uint8))
        np.testing.assert_array_equal(scales, os_)
        assert scales[4] == np.float32(2.0**-20)
        assert codes[off[4] + 3, 1].view(ml_dtypes.float8_e4m3fn).astype(np.float32) == -448.0
        assert (codes[off[1]:off[2]] == 0).all()
        return
    jt, ju = jnp.asarray(table), None if u is None else jnp.asarray(u)
    for level in range(jc.n_levels):
        q, s = jhgp.quantize_level_q8(jt, off[level], jc.level_sizes[level], ju)
        np.testing.assert_array_equal(codes[off[level]:off[level] + jc.level_sizes[level]]
                                      .view(np.int8), np.asarray(q))
        assert scales[level] == np.float32(s)
    q8 = codes.view(np.int8)
    assert scales[1] == np.float32(np.float32(1e-30) / np.float32(127))
    assert (q8[off[1]:off[2]] == 0).all() and scales[2] == 1.0
    if u is None:
        np.testing.assert_array_equal(q8[off[2]:off[2] + 6, 0], [127, 0, 2, 2, 0, -2])
    assert q8[at[0], 1] == 127 and q8[at[1], 0] == -127  # 128 and -128 clamped
    if u is not None:
        v = np.float32(table[at[0], 1] / scales[3])
        assert np.floor(v + noise[at[0], 1]) == 128.0


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("blocks", [1, 7, 132, kp.QUANTIZE_MAX_BLOCKS])
def test_quantize_plan_covers_every_row_once(name, blocks):
    """The plan's ranges tile the table in whole 8-row units, no block is
    empty, and ``level_blocks`` names exactly the blocks whose ranges hold
    rows of each level."""
    _, tc = _cfgs(name, "q8")
    plan = kp.quantize_plan(tc, blocks)
    assert plan.block_rows % 8 == 0 and 1 <= plan.blocks <= blocks
    assert plan.partials_shape == (plan.blocks, tc.n_levels)
    spans = [plan.block_span(b) for b in range(plan.blocks)]
    assert spans[0][0] == 0 and spans[-1][1] == tc.total_params
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(r1 > r0 for r0, r1 in spans)
    for off, size in zip(tc.level_offsets, tc.level_sizes):
        want = [b for b, (r0, r1) in enumerate(spans) if r0 < off + size and off < r1]
        assert list(plan.level_blocks(off, size)) == want
    if blocks == kp.QUANTIZE_MAX_BLOCKS:
        assert plan.blocks >= 132


def test_quantize_plan_at_the_flagship():
    """248 blocks of 512 rows for the 3-D table (one float4 a thread), 187 for
    the 2-D one."""
    for name, blocks in (("flagship pos", 248), ("flagship surface", 187)):
        plan = kp.quantize_plan(_cfgs(name, "q8")[1])
        assert (plan.blocks, plan.block_rows) == (blocks, 512), name
    assert "248 blocks of 256 threads" in kp.quantize_plan(_cfgs("flagship pos", "q8")[1]).describe()
    with pytest.raises(ValueError):
        kp.quantize_plan(_cfgs("flagship pos", "q8")[1], 0)
    with pytest.raises(ValueError):
        kp.quantize_plan(thg.HashGridConfig.from_options(dict(FLAGSHIP, n_levels=33), 3))


@pytest.mark.parametrize("mode", ["q8", "f8"])
def test_prepare_table_on_the_cpu_is_the_plain_version(mode):
    """On CPU tensors ``prepare_table`` runs the plain quantizer through
    ``quantize_tables`` and counts no launch; f8 takes no noise."""
    _, tc = _cfgs("flagship surface", mode)
    table, noise = (torch.from_numpy(a) for a in _inputs("flagship surface"))
    before = dict(thgo.quantize_tables.launches)
    with one_torch_thread():
        got = thgo.prepare_table(table, tc, mode, noise)
        want = (thgo.quantize_tables_q8(table, tc, noise) if mode == "q8"
                else thgo.quantize_tables_f8(table, tc))
    assert thgo.quantize_tables.launches == before
    assert torch.equal(got[0].view(torch.uint8), want[0].view(torch.uint8))
    assert torch.equal(got[1], want[1])


def test_quantize_tables_rejects_bad_inputs():
    _, tc = _cfgs("flagship surface", "q8")
    table, noise = (torch.from_numpy(a) for a in _inputs("flagship surface"))
    for args in ((table, tc, "bf16"), (table.double(), tc, "q8"), (table[:-8], tc, "q8"),
                 (table, tc, "f8", noise), (table, tc, "q8", noise[:-8]),
                 (table, tc, "q8", noise.double()), (table.to("meta"), tc, "q8"),
                 (table.to("meta"), tc, "q8", noise)):
        with pytest.raises(ValueError):
            thgo.quantize_tables(*args)
    pb = thg.HashGridConfig.from_options(dict(FLAGSHIP, hashed_tile="on", fwd_mode="q8"), 3)
    with pytest.raises(ValueError, match="hashed_tile"):
        thgo.quantize_tables(torch.zeros((pb.total_params, 2)), pb, "q8")
