"""Kernel T2's wrapper and plain version (``atmonr_tpu_torch/ops/block_fetch.py``)
against the JAX tool's own reference, on the CPU.

``tools/bench_dma_gather.py`` checks its Pallas block fetch against
``jnp.take`` of the table's tile rows at the expanded indices
``(idx[:, None] + arange(rpd)).reshape(-1)`` (its lines 172-179). The
Pallas kernel is a TPU DMA kernel with no interpret mode, so that reference
is what the port is held to, bit for bit, on numpy inputs from a seed. The
wrapper refuses what the JAX tool's asserts refuse. The kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmonr_tpu_torch.ops import block_fetch as bfo
from tools.bench_dma_gather import LANES, make_dma_block_fetch

TILE_ROWS = 300


def _inputs(seed: int, n_desc: int, rpd: int, tile_rows: int = TILE_ROWS):
    rng = np.random.default_rng(seed)
    tiles = rng.standard_normal((tile_rows, LANES)).astype(np.float32)
    idx = rng.integers(0, tile_rows - rpd, n_desc).astype(np.int32)
    return tiles, idx


def _jax_reference(tiles: np.ndarray, idx: np.ndarray, rpd: int) -> np.ndarray:
    """``tools/bench_dma_gather.py``'s check, as it is written there."""
    return np.asarray(
        jnp.take(jnp.asarray(tiles), (np.asarray(idx)[:, None] + np.arange(rpd)).reshape(-1),
                 axis=0)
    )


@pytest.mark.parametrize("n_desc", [256, 512])
@pytest.mark.parametrize("rpd", [1, 4, 32])
def test_block_fetch_equals_the_jax_reference(rpd, n_desc):
    """The wrapper on CPU tensors (the plain version) and the plain version
    itself: equal to ``jnp.take`` bit for bit, in output order."""
    tiles, idx = _inputs(rpd * 7 + n_desc, n_desc, rpd)
    want = _jax_reference(tiles, idx, rpd)
    got = bfo.block_fetch(torch.from_numpy(tiles), torch.from_numpy(idx), rpd)
    assert got.shape == (n_desc * rpd, LANES) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    plain = bfo.block_fetch_plain(torch.from_numpy(tiles), torch.from_numpy(idx), rpd)
    assert np.array_equal(plain.numpy(), want)


def test_a_cpu_call_launches_nothing():
    before = dict(bfo.block_fetch.launches)
    tiles, idx = _inputs(0, 256, 4)
    bfo.block_fetch(torch.from_numpy(tiles), torch.from_numpy(idx), 4)
    assert bfo.block_fetch.launches == before


def test_expanded_rows():
    idx = torch.tensor([5, 0, 17], dtype=torch.int32)
    assert bfo.expanded_rows(idx, 3).tolist() == [5, 6, 7, 0, 1, 2, 17, 18, 19]


@pytest.mark.parametrize("n_desc", [300, 128, 257])
def test_refuses_what_the_jax_asserts_refuse(n_desc):
    """``n_desc % 256 != 0``: the JAX tool asserts at its block of 256, the
    wrapper raises."""
    with pytest.raises(AssertionError):
        make_dma_block_fetch(TILE_ROWS, n_desc, bfo.BLOCK)
    tiles, idx = _inputs(1, n_desc, 1)
    with pytest.raises(ValueError, match="multiple of BLOCK = 256"):
        bfo.block_fetch(torch.from_numpy(tiles), torch.from_numpy(idx), 1)


def _bad_inputs():
    tiles, idx = _inputs(2, 256, 4)
    t, i = torch.from_numpy(tiles), torch.from_numpy(idx)
    return {
        "f64 table": (t.double(), i, 4, "float32"),
        "bf16 table": (t.bfloat16(), i, 4, "float32"),
        "64-wide rows": (t[:, :64].contiguous(), i, 4, "float32"),
        "1-D table": (t.reshape(-1), i, 4, "float32"),
        "int64 idx": (t, i.long(), 4, "int32"),
        "2-D idx": (t, i.reshape(16, 16), 4, "int32"),
        "strided table": (t[::2], i[:256], 4, "contiguous"),
        "strided idx": (t, torch.from_numpy(np.repeat(idx, 2))[::2], 4, "contiguous"),
        "no rows": (t, i, 0, "rows_per_desc"),
        "more rows than the table": (t, i, TILE_ROWS + 1, "rows_per_desc"),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_refuses_bad_inputs(case):
    """What the kernel does not take: float32 rows of 128, int32 (n_desc,)
    indices, contiguous, 1 <= rows_per_desc <= rows."""
    table, idx, rpd, match = _bad_inputs()[case]
    with pytest.raises(ValueError, match=match):
        bfo.block_fetch(table, idx, rpd)


@pytest.mark.parametrize("start", [-1, TILE_ROWS - 3])
def test_a_run_outside_the_table_raises_on_the_cpu(start):
    """The plain version reads nothing outside the table: ``index_select``
    raises (on the card the kernel writes NaN rows instead)."""
    tiles, idx = _inputs(3, 256, 4)
    idx[17] = start
    with pytest.raises((IndexError, RuntimeError)):
        bfo.block_fetch(torch.from_numpy(tiles), torch.from_numpy(idx), 4)


def test_the_tool_checks_a_point_with_torch_equal(monkeypatch):
    """``tools.bench_dma_gather.check_block_fetch`` raises on a wrong row."""
    from atmonr_tpu_torch.tools import bench_dma_gather as bdg

    tiles, idx = _inputs(4, 256, 1)
    t, i = torch.from_numpy(tiles), torch.from_numpy(idx)
    assert bdg.check_block_fetch(t, i, 1) == 0.0

    def wrong(table, ix, rpd):
        out = bfo.block_fetch_plain(table, ix, rpd).clone()
        out[5, 7] += 1.0
        return out

    monkeypatch.setattr(bfo, "block_fetch", wrong)
    with pytest.raises(RuntimeError, match="differs from its plain version in 1 rows"):
        bdg.check_block_fetch(t, i, 1)
