"""Hash-encode forward over bf16, f32, int8 (q8) and float8 (f8) tables:
kernel K1 of the port.

Replaces the TPU kernel ``atmonr_tpu/ops/hash_gather_pallas.py::
hash_encode_pallas_fwd`` in its four modes. The parts:

- ``prepare_table``: the table as a mode's kernel reads it, from the float32
  master table. ``"bf16"``: the table rounded to bfloat16 (nearest even), a
  natural (T, 2) tensor. ``"f32"``: the master table itself.
  ``"q8"`` (``quantize_tables_q8``): per-level symmetric int8 with scale
  ``s = max|t| / 127``, rounding to nearest or, with noise ``u``,
  ``floor(t/s + u)`` (stochastic rounding), clipped to +-127. ``"f8"``
  (``quantize_tables_f8``): per-level float8_e4m3fn codes of ``t / s`` with
  the power-of-two scale ``s = 2^ceil(log2(max|t| / 448))``. All plain
  tensor ops, as in the JAX package (XLA glue outside the kernel). The TPU
  kernel's u32 packing, 128-lane chunks and padding are layout for its lane
  gather and are not carried over.
- ``hash_gather``: the wrapper of the CUDA kernel ``csrc/hash_gather.cu``.
  On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
  runs ``hash_gather_plain``. The table's dtype says which mode it is.
- ``hash_gather_plain``: the same gathers written with tensor indexing over
  the table decoded to float32, the corner sum in the kernel's order, then
  (q8, f8) the multiply by ``s``.
- ``hash_encode_kernel``: prepare + gather from the float32 master table as
  a ``torch.autograd.Function`` whose backward is kernel K2
  (``ops/hash_bwd.py``), straight through the cast or the quantizer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from atmonr_tpu_torch.models.hash_grid import (
    KERNEL_MODES,
    HashGridConfig,
    _hash_encode_exact,
)
from atmonr_tpu_torch.ops.hash_bwd import check_grid, hash_bwd, level_args
from atmonr_tpu_torch.ops.kernel_plan import level_plan

TABLE_DTYPES = {
    "bf16": torch.bfloat16,
    "f32": torch.float32,
    "q8": torch.int8,
    "f8": torch.float8_e4m3fn,
}
_MODE_OF_DTYPE = {dtype: mode for mode, dtype in TABLE_DTYPES.items()}
_ELEM = {"q8": 0, "bf16": 1, "f32": 2, "f8": 3}  # `elem` of csrc/hash_gather.cu
_SCALED = ("q8", "f8")
ROW_BYTES = {"q8": 2, "bf16": 4, "f32": 8, "f8": 2}  # of a table row, two features
F8_MAX = 448.0  # the largest float8_e4m3fn


@functools.cache
def _row_levels(cfg: HashGridConfig, device: torch.device) -> torch.Tensor:
    """(total_params,) level of each table row, on ``device``."""
    sizes = torch.tensor(cfg.level_sizes)
    return torch.repeat_interleave(torch.arange(cfg.n_levels), sizes).to(device)


def _level_amax(table: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """(L,) largest |entry| of each level, floored at 1e-30: one scatter
    over the table's rows."""
    rows = _row_levels(cfg, table.device)
    amax = torch.zeros(cfg.n_levels, dtype=table.dtype, device=table.device)
    amax = amax.scatter_reduce(0, rows, torch.abs(table).amax(dim=1), "amax", include_self=False)
    return torch.clamp(amax, min=1e-30)


def quantize_tables_q8(
    table: torch.Tensor, cfg: HashGridConfig, noise: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """All levels -> (int8 (total_params, F) table, (L,) f32 scales), in one
    pass over the table: a per-level max by scatter, then each row divided
    by its level's scale. ``noise`` (table-shaped, U[0,1)) switches from
    rounding to nearest to stochastic rounding ``floor(t/s + u)``."""
    scales = _level_amax(table, cfg) / 127.0
    t = table / scales[_row_levels(cfg, table.device)][:, None]
    q = torch.round(t) if noise is None else torch.floor(t + noise)
    return torch.clamp(q, -127, 127).to(torch.int8), scales


def quantize_tables_f8(
    table: torch.Tensor, cfg: HashGridConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """All levels -> (float8_e4m3fn (total_params, F) codes, (L,) f32
    scales), in one pass like ``quantize_tables_q8``.

    The scale is the JAX package's ``exp2(ceil(log2(m / 448)))`` with
    ``m = max(max|t|, 1e-30)``, evaluated exactly: ``m / 448 = f * 2^e`` with
    ``f`` in [0.5, 1) has ``ceil(log2) = e``, or ``e - 1`` when ``f`` is
    exactly 0.5. So ``s`` is a power of two, ``|t / s| <= 448`` never
    saturates, and the cast rounds to nearest even."""
    mant, exp = torch.frexp(_level_amax(table, cfg) / F8_MAX)
    scales = torch.ldexp(torch.ones_like(mant), torch.where(mant == 0.5, exp - 1, exp))
    t = table / scales[_row_levels(cfg, table.device)][:, None]
    return t.to(torch.float8_e4m3fn), scales


def prepare_table(
    table: torch.Tensor, cfg: HashGridConfig, mode: str, noise: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The float32 master table as ``mode``'s kernel reads it: (table of
    ``TABLE_DTYPES[mode]``, (L,) f32 scales or None). ``noise`` is q8's
    stochastic rounding."""
    if mode == "q8":
        return quantize_tables_q8(table, cfg, noise)
    if mode == "f8":
        return quantize_tables_f8(table, cfg)
    if mode not in KERNEL_MODES:
        raise ValueError(f"no hash gather kernel for mode {mode!r}; known: {KERNEL_MODES}")
    return table.to(TABLE_DTYPES[mode]), None


def hash_gather_plain(
    table: torch.Tensor, scales: torch.Tensor | None, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (M, D) positions -> (M, L*F).

    The exact gather over the table's entries decoded to float32 (summed in
    f32 in corner order, x bit fastest), then, where the table has scales,
    one multiply by each level's scale, as the Pallas kernel and
    ``csrc/hash_gather.cu`` order it."""
    feats = _hash_encode_exact(table.to(torch.float32), x, cfg)
    if scales is None:
        return feats
    return feats * scales.repeat_interleave(cfg.n_features_per_level)


@functools.cache
def _kernel():
    """The C entry point of ``csrc/hash_gather.cu``, built at first use."""
    from atmonr_tpu_torch import _build

    fn = _build.load("hash_gather").hash_gather
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _check_inputs(table, scales, x, cfg: HashGridConfig) -> str:
    """Raises on inputs the gather does not take; returns the table's mode."""
    check_grid(cfg, "the hash gather")
    mode = _MODE_OF_DTYPE.get(table.dtype)
    if mode is None or table.shape != (cfg.total_params, 2):
        raise ValueError(
            f"table must be ({cfg.total_params}, 2) of one of {sorted(map(str, _MODE_OF_DTYPE))}"
        )
    if (scales is not None) != (mode in _SCALED):
        raise ValueError(f"a {mode} table goes {'with' if mode in _SCALED else 'without'} scales")
    tensors = [table, x]
    if scales is not None:
        if scales.dtype != torch.float32 or scales.shape != (cfg.n_levels,):
            raise ValueError(f"scales must be float32 ({cfg.n_levels},)")
        tensors.append(scales)
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != cfg.n_dims:
        raise ValueError(f"x must be float32 (M, {cfg.n_dims})")
    if any(t.device != x.device for t in tensors):
        raise ValueError("table, scales and x must be on one device")
    return mode


def hash_gather(
    table: torch.Tensor, scales: torch.Tensor | None, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """Kernel K1: (M, D) f32 positions -> (M, L*2) f32 features from a table
    of ``prepare_table`` (bf16, f32, int8 or float8_e4m3fn; per-level scales
    with the last two).

    CUDA tensors go to the kernel of ``csrc/hash_gather.cu`` (built at first
    use) on the current stream, the levels as ``level_plan`` takes them, and
    each launch adds one to ``hash_gather.launches[(mode, D)]``; a failed
    build or launch raises. CPU tensors go to ``hash_gather_plain``. Other
    devices raise."""
    mode = _check_inputs(table, scales, x, cfg)
    if x.device.type == "cpu":
        return hash_gather_plain(table, scales, x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"no hash gather for device {x.device}")
    fn = _kernel()
    plan = level_plan(cfg, x.shape[0], ROW_BYTES[mode], False)
    x = x.contiguous()
    table = table.contiguous()
    if plan.staged and table.data_ptr() % 16:  # a block copies a level 16 bytes at a time
        table = table.clone()
    scales = None if scales is None else scales.contiguous()
    out = torch.empty((x.shape[0], cfg.n_output_dims), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), table.data_ptr(), None if scales is None else scales.data_ptr(),
            out.data_ptr(), x.shape[0], cfg.n_dims, cfg.n_levels, cfg.hashmap_size - 1,
            *level_args(cfg), _ELEM[mode],
            int(plan.staged), plan.chunk_points, plan.shared_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_gather ({mode}) launch failed: CUDA error {err}")
    hash_gather.launches[(mode, cfg.n_dims)] += 1
    return out


hash_gather.launches = {(mode, d): 0 for mode in KERNEL_MODES for d in (2, 3)}


class _HashEncode(torch.autograd.Function):
    """Prepare + gather, with the table gradient straight through the cast
    or the quantizer: the backward is ``hash_bwd`` on the saved positions,
    the gradient of the float32 master table. It is exact float32 whatever
    the forward's precision, and independent of the noise."""

    @staticmethod
    def forward(ctx, table, x, noise, cfg, mode):
        ctx.save_for_backward(x)
        ctx.cfg = cfg
        prepared, scales = prepare_table(table, cfg, mode, noise)
        return hash_gather(prepared, scales, x, cfg)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return hash_bwd(x, g.to(torch.float32), ctx.cfg), None, None, None, None


def hash_encode_kernel(
    table: torch.Tensor,
    x: torch.Tensor,
    cfg: HashGridConfig,
    mode: str,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hash encode of (M, D) positions from the f32 master table in kernel
    mode ``mode``: ``prepare_table`` (q8 with stochastic rounding when
    ``noise`` is given), then ``hash_gather``. Under autograd the table's
    gradient is kernel K2 (``hash_bwd``); positions get none, so an ``x``
    that requires grad raises (the exact ``"xla"`` mode differentiates
    positions)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(
            f"the {mode} hash encode has no position gradient; use fwd_mode "
            "'xla' to differentiate positions"
        )
    return _HashEncode.apply(table, x.to(torch.float32), noise, cfg, mode)
