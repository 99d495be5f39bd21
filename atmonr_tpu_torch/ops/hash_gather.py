"""Hash-encode forward over int8 (q8) tables: kernel K1 of the port.

Replaces the TPU kernel ``atmonr_tpu/ops/hash_gather_pallas.py::
hash_encode_pallas_fwd`` in ``"q8"`` mode. Four parts:

- ``quantize_tables_q8``: per-level symmetric int8 quantization with scale ``s = max|t| / 127``, rounding to nearest or, with
  noise ``u``, ``floor(t/s + u)`` (stochastic rounding), clipped to +-127.
  Plain tensor ops, as in the JAX package (XLA glue outside the kernel);
  bit-equal to it.
- ``hash_gather_q8``: the wrapper of the CUDA kernel
  ``csrc/hash_gather.cu``. On a CUDA tensor it launches the kernel, or
  raises; on a CPU tensor it runs ``hash_gather_q8_plain``.
- ``hash_gather_q8_plain``: the same gathers written with tensor indexing,
  the corner sum in the kernel's order, then the multiply by ``s``.
- ``hash_encode_q8``: quantize + gather from the float32 master table as a
  ``torch.autograd.Function`` whose backward is kernel K2
  (``ops/hash_bwd.py``), straight through the quantizer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from atmonr_tpu_torch.models.hash_grid import HashGridConfig, _hash_encode_exact
from atmonr_tpu_torch.ops.hash_bwd import check_grid, hash_bwd, level_args


@functools.cache
def _row_levels(cfg: HashGridConfig, device: torch.device) -> torch.Tensor:
    """(total_params,) level of each table row, on ``device``."""
    sizes = torch.tensor(cfg.level_sizes)
    return torch.repeat_interleave(torch.arange(cfg.n_levels), sizes).to(device)


def quantize_tables_q8(
    table: torch.Tensor, cfg: HashGridConfig, noise: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """All levels -> (int8 (total_params, F) table, (L,) f32 scales), in one
    pass over the table: a per-level max by scatter, then each row divided
    by its level's scale. ``noise`` (table-shaped, U[0,1)) switches from
    rounding to nearest to stochastic rounding ``floor(t/s + u)``."""
    rows = _row_levels(cfg, table.device)
    amax = torch.zeros(cfg.n_levels, dtype=table.dtype, device=table.device)
    amax = amax.scatter_reduce(0, rows, torch.abs(table).amax(dim=1), "amax", include_self=False)
    scales = torch.clamp(amax, min=1e-30) / 127.0
    t = table / scales[rows][:, None]
    q = torch.round(t) if noise is None else torch.floor(t + noise)
    return torch.clamp(q, -127, 127).to(torch.int8), scales


def hash_gather_q8_plain(
    qtable: torch.Tensor, scales: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (M, D) positions -> (M, L*F).

    The exact gather over the int8 features (summed in f32 in corner order,
    x bit fastest), then one multiply by each level's scale, as the Pallas
    kernel and ``csrc/hash_gather.cu`` order it."""
    feats = _hash_encode_exact(qtable.to(torch.float32), x, cfg)
    return feats * scales.repeat_interleave(cfg.n_features_per_level)


@functools.cache
def _kernel():
    """The C entry point of ``csrc/hash_gather.cu``, built at first use."""
    from atmonr_tpu_torch import _build

    fn = _build.load("hash_gather").hash_gather_q8
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p,
    ]
    return fn


def _check_inputs(qtable, scales, x, cfg: HashGridConfig) -> None:
    check_grid(cfg, "the q8 gather")
    if qtable.dtype != torch.int8 or qtable.shape != (cfg.total_params, 2):
        raise ValueError(f"qtable must be int8 ({cfg.total_params}, 2)")
    if scales.dtype != torch.float32 or scales.shape != (cfg.n_levels,):
        raise ValueError(f"scales must be float32 ({cfg.n_levels},)")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != cfg.n_dims:
        raise ValueError(f"x must be float32 (M, {cfg.n_dims})")
    if not (qtable.device == scales.device == x.device):
        raise ValueError("qtable, scales and x must be on one device")


def hash_gather_q8(
    qtable: torch.Tensor, scales: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """Kernel K1: (M, D) f32 positions -> (M, L*2) f32 features from the
    int8 table and per-level scales of ``quantize_tables_q8``.

    CUDA tensors go to the kernel of ``csrc/hash_gather.cu`` (built at first
    use) on the current stream, and each launch adds one to
    ``hash_gather_q8.launches[D]``; a failed launch raises. CPU tensors go
    to ``hash_gather_q8_plain``. Other devices raise."""
    _check_inputs(qtable, scales, x, cfg)
    if x.device.type == "cpu":
        return hash_gather_q8_plain(qtable, scales, x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"no q8 gather for device {x.device}")
    fn = _kernel()
    level_scale, level_res, level_offset, level_dense = level_args(cfg)
    x = x.contiguous()
    qtable = qtable.contiguous()
    scales = scales.contiguous()
    out = torch.empty((x.shape[0], cfg.n_output_dims), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), qtable.data_ptr(), scales.data_ptr(), out.data_ptr(),
            x.shape[0], cfg.n_dims, cfg.n_levels, cfg.hashmap_size - 1,
            level_scale, level_res, level_offset, level_dense, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_gather_q8 launch failed: CUDA error {err}")
    hash_gather_q8.launches[cfg.n_dims] += 1
    return out


hash_gather_q8.launches = {2: 0, 3: 0}


class _HashEncodeQ8(torch.autograd.Function):
    """Quantize + gather, with the table gradient straight through the
    quantizer: the backward is ``hash_bwd`` on the saved positions, the
    gradient of the float32 master table. It is exact float32 whatever the
    forward's rounding, and independent of the noise."""

    @staticmethod
    def forward(ctx, table, x, noise, cfg):
        ctx.save_for_backward(x)
        ctx.cfg = cfg
        qtable, scales = quantize_tables_q8(table, cfg, noise)
        return hash_gather_q8(qtable, scales, x, cfg)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return hash_bwd(x, g.to(torch.float32), ctx.cfg), None, None, None


def hash_encode_q8(
    table: torch.Tensor,
    x: torch.Tensor,
    cfg: HashGridConfig,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """q8 hash encode of (M, D) positions from the f32 master table:
    quantize (with stochastic rounding when ``noise`` is given), then
    ``hash_gather_q8``. Under autograd the table's gradient is kernel K2
    (``hash_bwd``); positions get none, so an ``x`` that requires grad
    raises (the exact ``"xla"`` mode differentiates positions)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(
            "the q8 hash encode has no position gradient; use fwd_mode "
            "'xla' to differentiate positions"
        )
    return _HashEncodeQ8.apply(table, x.to(torch.float32), noise, cfg)
