"""Hash-encode forward over bf16, f32, int8 (q8) and float8 (f8) tables:
kernels K1 (the gather) and K1p (the q8/f8/bf16 table preparation) of the
port.

Replaces the TPU kernel ``atmonr_tpu/ops/hash_gather_pallas.py::
hash_encode_pallas_fwd`` in its four modes: its table packing and
quantization (``pack_tables``) and its gather. The parts:

- ``prepare_table``: the table as a mode's kernel reads it, from the float32
  master table. ``"bf16"``: ``round_table_bf16``, a natural (T, 2) tensor.
  ``"f32"``: the master table itself. ``"q8"`` and ``"f8"``:
  ``quantize_tables``. Each call adds one to ``prepare_table.calls[(mode,
  D)]``, on every device.
- ``round_table_bf16``: the table rounded to bfloat16 (nearest even). On a
  CUDA tensor it launches the bf16 instance of K1p (``round_bf16_kernel`` of
  ``csrc/quantize.cu``), bit for bit ``table.to(torch.bfloat16)`` there; on
  a CPU tensor it runs that cast.
- ``quantize_tables``: the wrapper of the CUDA kernel ``csrc/quantize.cu``
  (K1p). On a CUDA tensor it launches the kernel, or raises; on a CPU
  tensor it runs the plain version: ``quantize_tables_q8`` (per-level
  symmetric int8 with scale ``s = max|t| / 127``, rounding to nearest or,
  with noise ``u``, ``floor(t/s + u)`` (stochastic rounding), clipped to
  +-127) or ``quantize_tables_f8`` (per-level float8_e4m3fn codes of
  ``t / s`` with the power-of-two scale ``s = 2^ceil(log2(max|t| / 448))``),
  plain tensor ops as in the JAX package (XLA glue outside its kernel). The
  TPU kernel's u32 packing, 128-lane chunks and padding are layout for its
  lane gather and are not carried over.
- ``hash_gather``: the wrapper of the CUDA kernel ``csrc/hash_gather.cu``
  (K1). On a CUDA tensor it launches the kernel, or raises; on a CPU tensor
  it runs ``hash_gather_plain``. The table's dtype says which mode it is.
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
from atmonr_tpu_torch.ops.kernel_plan import (
    QUANTIZE_CLUSTER,
    QuantizePlan,
    level_plan,
    quantize_plan,
)
from atmonr_tpu_torch.utils import spans

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


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true float32 division on every device, as the JAX
    package and the CPU compute it: PyTorch's CUDA kernels multiply by the
    reciprocal of a Python-number divisor, an ulp off for some quotients."""
    return x / torch.full_like(x, d)


def quantize_tables_q8(
    table: torch.Tensor, cfg: HashGridConfig, noise: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K1p in q8: all levels -> (int8
    (total_params, F) table, (L,) f32 scales), with tensor ops on any
    device: a per-level max by scatter, then each row divided by its
    level's scale. ``noise`` (table-shaped, U[0,1)) switches from rounding
    to nearest to stochastic rounding ``floor(t/s + u)``."""
    scales = _true_div(_level_amax(table, cfg), 127.0)
    t = table / scales[_row_levels(cfg, table.device)][:, None]
    q = torch.round(t) if noise is None else torch.floor(t + noise)
    return torch.clamp(q, -127, 127).to(torch.int8), scales


def quantize_tables_f8(
    table: torch.Tensor, cfg: HashGridConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K1p in f8: all levels ->
    (float8_e4m3fn (total_params, F) codes, (L,) f32 scales), like
    ``quantize_tables_q8``.

    The scale is the JAX package's ``exp2(ceil(log2(m / 448)))`` with
    ``m = max(max|t|, 1e-30)``, evaluated exactly: ``m / 448 = f * 2^e`` with
    ``f`` in [0.5, 1) has ``ceil(log2) = e``, or ``e - 1`` when ``f`` is
    exactly 0.5. So ``s`` is a power of two, ``|t / s| <= 448`` never
    saturates, and the cast rounds to nearest even."""
    mant, exp = torch.frexp(_true_div(_level_amax(table, cfg), F8_MAX))
    scales = torch.ldexp(torch.ones_like(mant), torch.where(mant == 0.5, exp - 1, exp))
    t = table / scales[_row_levels(cfg, table.device)][:, None]
    return t.to(torch.float8_e4m3fn), scales


def prepare_table(
    table: torch.Tensor, cfg: HashGridConfig, mode: str, noise: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The float32 master table as ``mode``'s kernel reads it: (table of
    ``TABLE_DTYPES[mode]``, (L,) f32 scales or None). ``noise`` is q8's
    stochastic rounding. q8 and f8 go to ``quantize_tables`` and bf16 to
    ``round_table_bf16`` (kernel K1p on a card); f32 is the table itself.
    Each call adds one to ``prepare_table.calls[(mode, D)]``."""
    if mode not in KERNEL_MODES:
        raise ValueError(f"no hash gather kernel for mode {mode!r}; known: {KERNEL_MODES}")
    prepare_table.calls[(mode, cfg.n_dims)] += 1
    if mode in _SCALED:
        return quantize_tables(table, cfg, mode, noise if mode == "q8" else None)
    if mode == "bf16":
        return round_table_bf16(table, cfg), None
    return table, None


prepare_table.calls = {(mode, d): 0 for mode in KERNEL_MODES for d in (2, 3)}


def round_table_bf16(table: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """The bf16 instance of kernel K1p: the (total_params, 2) float32 master
    table -> the bfloat16 table, each entry rounded to nearest even.

    A CUDA tensor goes to ``round_bf16_kernel`` of ``csrc/quantize.cu``
    (built at first use) on the current stream, one launch, which adds one
    to ``round_table_bf16.launches[D]``; it equals ``table.to(torch.bfloat16)``
    on the card bit for bit, and a failed launch raises. A CPU tensor takes
    that cast. Other devices raise."""
    shape = (cfg.total_params, 2)
    if table.dtype != torch.float32 or table.shape != shape:
        raise ValueError(f"table must be float32 {shape}")
    if table.device.type == "cpu":
        return table.to(torch.bfloat16)
    if table.device.type != "cuda":
        raise ValueError(f"no bf16 table rounding for device {table.device}")
    table = table.contiguous()
    if table.data_ptr() % 16:  # the kernel reads float4s
        table = table.clone()
    out = torch.empty(shape, dtype=torch.bfloat16, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _quantize_library().round_table_bf16(table.data_ptr(), out.data_ptr(),
                                                   table.numel(), stream)
    if err != 0:
        raise RuntimeError(f"round_table_bf16 launch failed: CUDA error {err}")
    round_table_bf16.launches[cfg.n_dims] += 1
    return out


round_table_bf16.launches = {2: 0, 3: 0}


@functools.cache
def _quantize_library():
    """The library of ``csrc/quantize.cu``, built at first use, with its C
    entry points' signatures set."""
    from atmonr_tpu_torch import _build

    lib = _build.load("quantize")
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.quantize_tables.restype = c_int
    lib.quantize_tables.argtypes = [
        c_ptr, c_ptr, c_ptr, c_ptr, ctypes.c_longlong, c_int, ctypes.POINTER(c_int),
        ctypes.POINTER(c_int), c_int, c_int, c_int, c_ptr,
    ]
    lib.quantize_max_active_clusters.restype = c_int
    lib.quantize_max_active_clusters.argtypes = [
        c_int, c_int, c_int, c_int, c_int, ctypes.POINTER(c_int),
    ]
    lib.quantize_launch_floor.restype = c_int
    lib.quantize_launch_floor.argtypes = [c_int, c_int, c_int, c_ptr]
    lib.round_table_bf16.restype = c_int
    lib.round_table_bf16.argtypes = [c_ptr, c_ptr, ctypes.c_longlong, c_ptr]
    return lib


@functools.cache
def quantize_max_active_clusters(plan: QuantizePlan, mode: str, noise: bool,
                                 device_index: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K1p's launch in ``plan`` for
    ``mode`` (with ``noise``) on card ``device_index``: how many of its
    clusters the card can hold at once. It also allows the kernel its noise
    stage's shared memory on that card, which ``quantize_tables`` needs
    before its first launch there. Raises where the query fails; 0 means
    the launch cannot be scheduled."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _quantize_library().quantize_max_active_clusters(
            int(mode == "f8"), int(noise), len(plan.sizes), plan.cluster, plan.threads,
            ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"quantize_tables ({mode}): cluster occupancy query failed: "
                           f"CUDA error {err}")
    return out.value


def quantize_launch_floor(plan: QuantizePlan, device: torch.device) -> None:
    """One launch of an empty kernel in ``plan``'s grid and cluster shape on
    the current stream: the fixed cost under K1p's time, for the
    measurement scripts. It counts nowhere and no path calls it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _quantize_library().quantize_launch_floor(len(plan.sizes), plan.cluster,
                                                         plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"quantize_launch_floor failed: CUDA error {err}")


def quantize_tables(
    table: torch.Tensor, cfg: HashGridConfig, mode: str, noise: torch.Tensor | None = None,
    cluster: int = QUANTIZE_CLUSTER,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1p: the (total_params, 2) float32 master table -> (int8 or
    float8_e4m3fn (total_params, 2) codes, (L,) f32 scales) for ``mode``
    ``"q8"`` (``noise``: stochastic rounding) or ``"f8"`` (no noise).

    CUDA tensors go to the kernel of ``csrc/quantize.cu`` (built at first
    use) on the current stream: one launch in ``quantize_plan(cfg,
    cluster)``, a cluster of ``cluster`` blocks a level, and each call adds
    one to ``quantize_tables.launches[(mode, D)]``. A failed build or launch
    raises, and so does a plan whose clusters the card cannot schedule
    (checked once a plan). CPU tensors go to the plain version,
    ``quantize_tables_q8`` or ``quantize_tables_f8``, equal to the kernel
    bit for bit. Other devices raise."""
    check_grid(cfg, "the table quantizer")
    if mode not in _SCALED:
        raise ValueError(f"the table quantizer takes modes {_SCALED}, not {mode!r}")
    shape = (cfg.total_params, 2)
    if table.dtype != torch.float32 or table.shape != shape:
        raise ValueError(f"table must be float32 {shape}")
    if noise is not None:
        if mode != "q8":
            raise ValueError("only q8 rounds with noise")
        if noise.dtype != torch.float32 or noise.shape != shape or noise.device != table.device:
            raise ValueError(f"noise must be float32 {shape} on the table's device")
    if table.device.type == "cpu":
        if mode == "q8":
            return quantize_tables_q8(table, cfg, noise)
        return quantize_tables_f8(table, cfg)
    if table.device.type != "cuda":
        raise ValueError(f"no table quantizer for device {table.device}")
    plan = quantize_plan(cfg, cluster)
    if quantize_max_active_clusters(plan, mode, noise is not None, table.device.index) < 1:
        raise RuntimeError(f"quantize_tables ({mode}): the card cannot schedule a cluster of "
                           f"{plan.cluster} blocks of {plan.threads} threads")

    def aligned(t):  # the kernel reads float4s
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    table = aligned(table)
    noise = None if noise is None else aligned(noise)
    codes = torch.empty(shape, dtype=TABLE_DTYPES[mode], device=table.device)
    scales = torch.empty((cfg.n_levels,), dtype=torch.float32, device=table.device)
    slice_rows = (ctypes.c_int * cfg.n_levels)(*plan.slice_rows)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _quantize_library().quantize_tables(
            table.data_ptr(), None if noise is None else noise.data_ptr(), codes.data_ptr(),
            scales.data_ptr(), cfg.total_params, cfg.n_levels, level_args(cfg)[2], slice_rows,
            int(mode == "f8"), plan.cluster, plan.threads, stream,
        )
    if err != 0:
        raise RuntimeError(f"quantize_tables ({mode}) launch failed: CUDA error {err}")
    quantize_tables.launches[(mode, cfg.n_dims)] += 1
    return codes, scales


quantize_tables.launches = {(mode, d): 0 for mode in _SCALED for d in (2, 3)}


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
    plan = level_plan(cfg, x.shape[0], ROW_BYTES[mode], False)
    x = x.contiguous()
    table = table.contiguous()
    if plan.staged and table.data_ptr() % 16:  # a block copies a level 16 bytes at a time
        table = table.clone()
    scales = None if scales is None else scales.contiguous()
    out = torch.empty((x.shape[0], cfg.n_output_dims), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    launch_kernel(table, scales, x, out, cfg, mode, plan)
    return out


hash_gather.launches = {(mode, d): 0 for mode in KERNEL_MODES for d in (2, 3)}


def launch_kernel(table, scales, x, out, cfg: HashGridConfig, mode: str, plan) -> None:
    """One launch of the kernel into ``out`` on the current stream, as
    ``plan`` (``level_plan`` of these points) takes the levels, with no check
    and no allocation: the kernel body alone, which ``hash_gather`` wraps and
    ``tools/diag_fwd_breakdown.py`` times. The caller gives what
    ``hash_gather`` would: CUDA tensors, contiguous, the table 16-byte
    aligned, ``out`` (M, L*2) float32. Each launch adds one to
    ``hash_gather.launches[(mode, D)]``."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            x.data_ptr(), table.data_ptr(), None if scales is None else scales.data_ptr(),
            out.data_ptr(), x.shape[0], cfg.n_dims, cfg.n_levels, cfg.hashmap_size - 1,
            *level_args(cfg), _ELEM[mode],
            int(plan.staged), plan.chunk_points, plan.shared_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_gather ({mode}) launch failed: CUDA error {err}")
    hash_gather.launches[(mode, cfg.n_dims)] += 1


class _HashEncode(torch.autograd.Function):
    """Prepare + gather, with the table gradient straight through the cast
    or the quantizer: the backward is ``hash_bwd`` on the saved positions,
    the gradient of the float32 master table. It is exact float32 whatever
    the forward's precision, and independent of the noise."""

    @staticmethod
    def forward(ctx, table, x, noise, cfg, mode):
        with spans.span("hash_encode.fwd", count=len(x)):
            ctx.save_for_backward(x)
            ctx.cfg = cfg
            with spans.span("hash_encode.prepare", count=len(table)):
                prepared, scales = prepare_table(table, cfg, mode, noise)
            return hash_gather(prepared, scales, x, cfg)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with spans.span("hash_encode.bwd", count=len(x)):
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
