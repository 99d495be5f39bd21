"""Kernel K1p (``csrc/quantize.cu``, the q8/f8 table preparation) on the CPU:
its launch geometry (``ops/kernel_plan.py::quantize_plan``), a numpy
emulation of its single clustered launch held exactly to the JAX package's
quantizers and to the plain version, and the wrapper's CPU path. The kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``).

Inputs come from numpy with fixed seeds and go through both packages.
"""

import dataclasses
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
# clusters of 1 block (a level in one block), 2 and the plan's 8: the result
# does not depend on how a level is cut
CLUSTERS = {"cluster 1": 1, "cluster 2": 2, "plan": kp.QUANTIZE_CLUSTER}


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
    """The single launch of ``csrc/quantize.cu`` in numpy, cluster by
    cluster and block by block: (codes as uint8 (T, 2), scales (L,)).

    Block r of cluster l takes ``plan.slice(l, r)``, which must lie inside
    level l, and puts the largest |t| of its slice as the float's bits into
    its shared word (+0 for an empty slice). Every block of the cluster then
    reads the cluster's ``plan.cluster`` words, takes their maximum and the
    scale from it; rank 0 alone stores the scale. Each block writes the
    codes of its own slice with the scale it computed."""
    offs, sizes = cfg.level_offsets, cfg.level_sizes
    bits = (table.view(np.uint32) & np.uint32(0x7FFFFFFF)).max(axis=1)  # of a row
    codes = np.zeros(table.shape, np.uint8)
    scales = np.full(cfg.n_levels, np.nan, np.float32)
    stored = np.zeros(cfg.n_levels, np.int64)
    written = np.zeros(table.shape[0], np.int64)
    for lv in range(cfg.n_levels):
        spans = [plan.slice(lv, r) for r in range(plan.cluster)]
        assert all(offs[lv] <= r0 <= r1 <= offs[lv] + sizes[lv] for r0, r1 in spans)
        shared = [int(bits[r0:r1].max()) if r1 > r0 else 0 for r0, r1 in spans]
        for rank, (r0, r1) in enumerate(spans):
            scale = _level_scale(np.uint32(max(shared)).view(np.float32), mode)
            if rank == 0:
                scales[lv] = scale
                stored[lv] += 1
            u = None if noise is None else noise[r0:r1]
            codes[r0:r1] = _codes(table[r0:r1], scale, u, mode)
            written[r0:r1] += 1
    assert (stored == 1).all()  # each level's scale stored by exactly one block
    assert (written == 1).all()  # each row's codes written by exactly one block
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


@pytest.mark.parametrize("cluster", CLUSTERS.values(), ids=CLUSTERS)
@pytest.mark.parametrize("noise", [False, True], ids=["round", "noise"])
@pytest.mark.parametrize("name", GRIDS)
def test_emulation_matches_jax_q8(name, noise, cluster):
    """The kernel's reduction and quantization, emulated in its clusters,
    equal JAX's ``quantize_level_q8`` on every level (codes and scales) and
    the plain version, exactly."""
    _, tc = _cfgs(name, "q8")
    table, u = _inputs(name)
    plan = kp.quantize_plan(tc, cluster)
    assert plan.blocks == tc.n_levels * cluster
    codes, scales = emulate(table, u if noise else None, tc, "q8", plan)
    jq, js = _jax_q8(name, noise)
    np.testing.assert_array_equal(codes.view(np.int8), jq)
    np.testing.assert_array_equal(scales, js)
    with one_torch_thread():
        pq, ps = thgo.quantize_tables_q8(torch.from_numpy(table), tc,
                                         torch.from_numpy(u) if noise else None)
    np.testing.assert_array_equal(codes.view(np.int8), pq.numpy())
    np.testing.assert_array_equal(scales, ps.numpy())


@pytest.mark.parametrize("cluster", CLUSTERS.values(), ids=CLUSTERS)
@pytest.mark.parametrize("name", GRIDS)
def test_emulation_matches_jax_f8(name, cluster):
    """The same for f8: bit-equal to ``quantize_level_f8``'s formula
    evaluated exactly (``_f8_oracle``), to jnp's division and cast given the
    scale, and to the plain version; ``quantize_level_f8``'s own scale is
    XLA:CPU's ``exp2(ceil(log2(.)))``, which is not exactly a power of two,
    within ``_XLA_EXP2_RTOL`` (as ``test_f8_quantizer_matches_jax``)."""
    jc, tc = _cfgs(name, "f8")
    table, _ = _inputs(name)
    codes, scales = emulate(table, None, tc, "f8", kp.quantize_plan(tc, cluster))
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
    """The crafted levels of ``_edge_table``, emulated in clusters of 2: equal to
    JAX (q8: ``quantize_level_q8``; f8: its formula) and to the plain
    version, with the values each edge case implies."""
    jc, tc = _cfgs("flagship pos", mode[:2])
    table, noise, at = _edge_table(tc)
    u = noise if mode == "q8 noise" else None
    codes, scales = emulate(table, u, tc, mode[:2], kp.quantize_plan(tc, 2))
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
@pytest.mark.parametrize("cluster", kp.QUANTIZE_CLUSTERS)
def test_quantize_plan_covers_every_row_once(name, cluster):
    """The plan's slices tile each level in whole 8-row units, in order, none
    crosses a level, and each level is the one cluster of its index: the
    launch's blocks cover every row of the table once."""
    _, tc = _cfgs(name, "q8")
    plan = kp.quantize_plan(tc, cluster)
    assert (plan.cluster, plan.blocks) == (cluster, tc.n_levels * cluster)
    covered = np.zeros(tc.total_params, np.int64)
    for lv, (off, size) in enumerate(zip(tc.level_offsets, tc.level_sizes)):
        assert plan.slice_rows[lv] % 8 == 0
        spans = [plan.slice(lv, r) for r in range(cluster)]
        assert spans[0][0] == off and spans[-1][1] == off + size
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        for r0, r1 in spans:
            assert off <= r0 <= r1 <= off + size and r0 % 8 == 0 and r1 % 8 == 0
            covered[r0:r1] += 1
    assert (covered == 1).all()
    assert plan.threads in (256, 512)
    if plan.rounds == 1:  # a thread keeps its slice's float4s in registers
        assert max(plan.slice_rows) <= 2 * plan.threads * kp.QUANTIZE_VECS


def test_quantize_plan_at_the_flagship():
    """16 clusters of 8 blocks of 256 threads at both flagship tables, 512
    threads at the gate grid's 2^16-row levels (8,192 rows a block), every
    thread's float4s in registers at all four grids; clusters outside {1, 2,
    4, 8} and grids of more than 32 levels raise."""
    for name in ("flagship pos", "flagship surface"):
        plan = kp.quantize_plan(_cfgs(name, "q8")[1])
        assert (plan.blocks, plan.cluster, plan.threads, plan.rounds) == (128, 8, 256, 1), name
        assert plan.describe().startswith("16 clusters of 8 blocks of 256 threads"), name
    gate = kp.quantize_plan(_cfgs("gate 32 x 2^16", "q8")[1])
    assert (gate.blocks, gate.threads, max(gate.slice_rows), gate.rounds) == (256, 512, 8192, 1)
    assert kp.quantize_plan(_cfgs("2^14 pos", "q8")[1]).rounds == 1
    for cluster in (0, 3, 16):
        with pytest.raises(ValueError):
            kp.quantize_plan(_cfgs("flagship pos", "q8")[1], cluster)
    with pytest.raises(ValueError):
        kp.quantize_plan(thg.HashGridConfig.from_options(dict(FLAGSHIP, n_levels=33), 3))
    with pytest.raises(ValueError, match="multiples of 8"):  # a level of 12 rows
        kp.quantize_plan(_Levels(2, (12, 8), (0, 12), 20))


@dataclasses.dataclass(frozen=True)
class _Levels:
    """The fields of a grid config that ``quantize_plan`` reads."""

    n_levels: int
    level_sizes: tuple
    level_offsets: tuple
    total_params: int


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
