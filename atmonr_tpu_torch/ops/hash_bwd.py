"""Hash-table gradient of the hash encoding: kernel K2 of the port.

Replaces the TPU kernel ``atmonr_tpu/ops/hash_bwd_pallas.py::
hash_encode_pallas_bwd``. For positions ``x`` (M, D) and the output
cotangent ``g`` (M, L*2) it returns the cotangent of the flat (T, 2) float32
table, ``dW[off_l + idx, f] = sum_points sum_corners w * g[:, 2l + f]``, with
the corner indices and weights of the forward. It reads ``x`` and ``g`` only,
never the forward's quantization.

- ``hash_bwd``: the wrapper of the CUDA kernel ``csrc/hash_bwd.cu`` (float32
  atomic adds: block by block in shared memory where ``ops/kernel_plan.py``
  stages the launch's levels, straight into the table where it does not). On
  a CUDA tensor it launches the kernel, or raises; on a CPU tensor it runs
  ``hash_bwd_plain``.
- ``hash_bwd_plain``: the same sum with ``level_indices`` and ``index_add_``.

Both compute exact float32 products and a float32 sum, whatever ``bwd_mode``
the grid config names: the TPU package's ``"bf16"`` (its ``"auto"``) trades
operand precision for matrix-unit throughput, a trade atomics do not need,
and its ``"sort"`` is the same sum taken another way. The kernel's atomics
add in an order that changes from run to run, so its result agrees with the
plain version to float32 summation error and is not bit-reproducible.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from atmonr_tpu_torch.models.hash_grid import HashGridConfig, level_indices
from atmonr_tpu_torch.ops.kernel_plan import MAX_LEVELS, level_plan

ACC_BYTES = 8  # a staged row's two float32 accumulators


@functools.cache
def level_args(cfg: HashGridConfig):
    """Per-level scale, resolution, table offset, dense flag and row count
    as C arrays (one small set per grid config), as both kernels take them."""
    n = cfg.n_levels
    return (
        (ctypes.c_float * n)(*cfg.level_scales),
        (ctypes.c_int * n)(*cfg.level_resolutions),
        (ctypes.c_int * n)(*cfg.level_offsets),
        (ctypes.c_int * n)(*(int(cfg.level_is_dense(lv)) for lv in range(n))),
        (ctypes.c_int * n)(*cfg.level_sizes),
    )


def check_grid(cfg: HashGridConfig, what: str) -> None:
    """The grids both kernels take: 2 features, D in (2, 3), <= 32 levels,
    per-cell indexing (a pair-bucket grid would be another model)."""
    if cfg.hashed_tile != "off":
        raise ValueError(f"{what} indexes per cell; a hashed_tile grid has no kernel")
    if cfg.n_features_per_level != 2:
        raise ValueError(f"{what} takes 2 features per level")
    if cfg.n_dims not in (2, 3) or cfg.n_levels > MAX_LEVELS:
        raise ValueError(f"{what} takes D in (2, 3) and <= {MAX_LEVELS} levels")


def hash_bwd_plain(x: torch.Tensor, g: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (M, D) positions and (M, L*F)
    cotangent -> (total_params, F) float32 table cotangent, one
    ``index_add_`` per level over the ``w * g`` products of its corners."""
    f = cfg.n_features_per_level
    out = torch.zeros((cfg.total_params, f), dtype=torch.float32, device=x.device)
    for level in range(cfg.n_levels):
        idx, w = level_indices(x, cfg, level)
        g_l = g[:, level * f : (level + 1) * f].to(torch.float32)
        vals = w[..., None] * g_l[:, None, :]  # (M, 2^D, F)
        out.index_add_(0, (cfg.level_offsets[level] + idx).reshape(-1), vals.reshape(-1, f))
    return out


@functools.cache
def _kernel():
    """The C entry point of ``csrc/hash_bwd.cu``, built at first use."""
    from atmonr_tpu_torch import _build

    fn = _build.load("hash_bwd").hash_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _check_inputs(x, g, cfg: HashGridConfig) -> None:
    check_grid(cfg, "the hash-table gradient")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != cfg.n_dims:
        raise ValueError(f"x must be float32 (M, {cfg.n_dims})")
    if g.dtype != torch.float32 or g.shape != (x.shape[0], cfg.n_output_dims):
        raise ValueError(f"g must be float32 ({x.shape[0]}, {cfg.n_output_dims})")
    if x.device != g.device:
        raise ValueError("x and g must be on one device")


def hash_bwd(x: torch.Tensor, g: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Kernel K2: (M, D) f32 positions and (M, L*2) f32 cotangent ->
    (total_params, 2) f32 table cotangent.

    CUDA tensors go to the kernel of ``csrc/hash_bwd.cu`` (built at first
    use) on the current stream, the levels as ``level_plan`` takes them, and
    each launch adds one to ``hash_bwd.launches[D]``; a failed build or
    launch raises. CPU tensors go to ``hash_bwd_plain``. Other devices
    raise."""
    _check_inputs(x, g, cfg)
    if x.device.type == "cpu":
        return hash_bwd_plain(x, g, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"no hash-table gradient for device {x.device}")
    fn = _kernel()
    plan = level_plan(cfg, x.shape[0], ACC_BYTES, True)
    x = x.contiguous()
    g = g.contiguous()
    out = torch.zeros((cfg.total_params, 2), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), g.data_ptr(), out.data_ptr(),
            x.shape[0], cfg.n_dims, cfg.n_levels, cfg.hashmap_size - 1,
            *level_args(cfg),
            int(plan.staged), plan.chunk_points, plan.shared_bytes, plan.run_points, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_bwd launch failed: CUDA error {err}")
    hash_bwd.launches[cfg.n_dims] += 1
    return out


hash_bwd.launches = {2: 0, 3: 0}
