"""Block fetch of random runs of 512-byte table rows: kernel T2 of the port,
a probe of random-row gather bandwidth.

Replaces the TPU kernel ``tools/bench_dma_gather.py::make_dma_block_fetch``
(its DMA descriptors and semaphore are not carried over). For a table of
(R, 128) float32 tile rows (64 entries of two f32 features a row) and
(n_desc,) int32 start rows it returns the (n_desc * rpd, 128) rows
``out[j * rpd + r] = table[idx[j] + r]``.

- ``block_fetch``: the wrapper of the CUDA kernel ``csrc/block_fetch.cu``.
  On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
  runs ``block_fetch_plain``.
- ``block_fetch_plain``: ``index_select`` on the expanded rows
  ``(idx[:, None] + arange(rpd)).reshape(-1)``, which raises on a row
  outside the table. That one library call computes the same function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

ROW_FLOATS = 128  # a 512-byte tile row: the TPU's smallest HBM DMA slice
BLOCK = 256  # descriptors a grid step of the TPU kernel


def expanded_rows(idx: torch.Tensor, rows_per_desc: int) -> torch.Tensor:
    """(n_desc * rpd,) int64 table rows of the descriptors, in output order."""
    rpd = torch.arange(rows_per_desc, dtype=torch.int64, device=idx.device)
    return (idx.to(torch.int64)[:, None] + rpd).reshape(-1)


def block_fetch_plain(table: torch.Tensor, idx: torch.Tensor, rows_per_desc: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one ``index_select``."""
    return torch.index_select(table, 0, expanded_rows(idx, rows_per_desc))


@functools.cache
def _kernel():
    """The C entry point of ``csrc/block_fetch.cu``, built at first use."""
    from atmonr_tpu_torch import _build

    fn = _build.load("block_fetch").block_fetch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _check_inputs(table: torch.Tensor, idx: torch.Tensor, rows_per_desc: int) -> None:
    """Raises on what the kernel does not take; the JAX tool asserts
    ``n_desc % BLOCK == 0`` and slices 128-lane f32 rows."""
    if table.dtype != torch.float32 or table.ndim != 2 or table.shape[1] != ROW_FLOATS:
        raise ValueError(f"table must be float32 (rows, {ROW_FLOATS}), got {table.dtype} "
                         f"{tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise ValueError(f"idx must be int32 (n_desc,), got {idx.dtype} {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.device != idx.device:
        raise ValueError("table and idx must be on one device")
    if rows_per_desc < 1 or rows_per_desc > table.shape[0]:
        raise ValueError(f"rows_per_desc must be in [1, {table.shape[0]}], got {rows_per_desc}")
    if idx.shape[0] % BLOCK:
        raise ValueError(f"n_desc = {idx.shape[0]} must be a multiple of BLOCK = {BLOCK}")


def block_fetch(table: torch.Tensor, idx: torch.Tensor, rows_per_desc: int) -> torch.Tensor:
    """Kernel T2: (n_desc * rows_per_desc, 128) f32 rows of ``table``, run j
    starting at row ``idx[j]``.

    CUDA tensors go to the kernel of ``csrc/block_fetch.cu`` (built at first
    use) on the current stream, and each launch adds one to
    ``block_fetch.launches[rows_per_desc]``; a failed build or launch
    raises. The kernel reads no row outside the table: a run that would
    leave it comes out as NaN rows (no host sync checks the indices). CPU
    tensors go to ``block_fetch_plain``, which raises on such a run. Other
    devices raise."""
    _check_inputs(table, idx, rows_per_desc)
    if table.device.type == "cpu":
        return block_fetch_plain(table, idx, rows_per_desc)
    if table.device.type != "cuda":
        raise ValueError(f"no block fetch for device {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (rows are read as float4)")
    fn = _kernel()
    out = torch.empty((idx.shape[0] * rows_per_desc, ROW_FLOATS), dtype=torch.float32,
                      device=table.device)
    if out.shape[0] == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.shape[0],
                 idx.shape[0], rows_per_desc, stream)
    if err != 0:
        raise RuntimeError(f"block_fetch launch failed: CUDA error {err}")
    block_fetch.launches[rows_per_desc] = block_fetch.launches.get(rows_per_desc, 0) + 1
    return out


block_fetch.launches = {rpd: 0 for rpd in (1, 4, 32)}
