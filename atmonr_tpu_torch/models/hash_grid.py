"""Multiresolution hash-grid encoding (Instant-NGP) in PyTorch.

Counterpart of the JAX package's ``models/hash_grid.py``:

- L levels of feature grids with geometrically growing resolution
  ``scale_l = base * growth**l - 1``, ``res_l = ceil(scale_l) + 1``;
- levels whose dense vertex count fits in the 2**log2_hashmap_size table are
  indexed densely, larger levels via the spatial hash
  ``(x*1) xor (y*2654435761) xor (z*805459861) mod T`` (uint32 wraparound);
- D-linear interpolation of the 2**D corner feature vectors;
- features initialized U(-1e-4, 1e-4);
- all levels in one flat (total_params, F) table;
- ``hashed_tile: "on"`` (the pair-bucket hash, a different model): the
  hashed levels of a 3-D grid store overlapped (4,4,4)-entry windows at
  stride 3, each window hashed to one 64-entry bucket, so a cell's eight
  corners lie in one bucket (``level_indices``).

Forward modes, as in the JAX package: ``"xla"`` is the exact f32
per-corner gather, plain tensor indexing (the JAX package also computes it
outside Pallas); autograd differentiates it, the table and the positions.
``"bf16"`` (and ``"auto"``, which means it), ``"f32"``, ``"q8"`` and ``"f8"``
gather from a table held as bf16, f32, int8 or float8_e4m3fn with the CUDA
kernel of ``ops/hash_gather.py`` (its plain version on CPU tensors); their
table gradient is the CUDA kernel of ``ops/hash_bwd.py``, whatever the
forward's precision. ``resolve_fwd_mode`` says which of them a grid config
runs: it is the JAX package's TPU dispatch, a function of the config alone.
Pair-bucket grids never reach a kernel: the kernels index per cell.
The exact path (``"xla"``, and ``"xla_bf16"`` over the bf16-rounded
table), ``hash_encode_exact``, opens the kernel path's spans and counts
its calls in ``hash_encode_exact.calls[(mode, D)]``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch
from torch.autograd.graph import get_gradient_edge

from atmonr_tpu_torch.utils import spans

# spatial-hash primes, per the Instant-NGP paper (first dim intentionally 1)
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF

FWD_MODES = ("auto", "xla", "bf16", "f32", "q8", "f8")
# what resolve_fwd_mode returns: the four kernel modes and the two plain gathers
KERNEL_MODES = ("bf16", "f32", "q8", "f8")
EXACT_MODES = ("xla", "xla_bf16")
# the JAX package runs q8 and f8 only where every level has at most this
# many entries (its Pallas gate); larger grids compute the exact f32 gather
MAX_QUANTIZED_LEVEL_ENTRIES = 1 << 16
# every value the JAX package accepts; the port computes one gradient for all
BWD_MODES = ("auto", "f32", "bf16", "sort")
HASHED_TILE = ("off", "on")
# the pair-bucket window: _TILE_W entries per dim at stride _TILE_S, so any
# 2-entry corner run, and hence any 2^D corner cube, lies in one window
_TILE_W, _TILE_S = 4, 3


def _align(n: int, m: int = 8) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class HashGridConfig:
    """Static configuration of a multiresolution hash grid.

    ``fwd_mode`` is validated at construction (``FWD_MODES``), and so is
    ``hashed_tile`` (``"on"``: the pair-bucket hash of the 3-D hashed
    levels, a different model; it changes the collision structure and
    keeps the table's shape). ``bwd_mode`` is validated too: the port computes
    the exact float32 table gradient for every value the JAX package
    accepts (``ops/hash_bwd.py``). The JAX package's ``dense_tile`` and
    ``bwd_sort_pack`` options select TPU layouts, and are not read here.
    """

    n_dims: int
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    fwd_mode: str = "auto"
    hashed_tile: str = "off"
    bwd_mode: str = "auto"

    def __post_init__(self) -> None:
        if self.bwd_mode not in BWD_MODES:
            raise ValueError(
                f"unknown bwd_mode {self.bwd_mode!r}; known: {BWD_MODES}"
            )
        if self.fwd_mode not in FWD_MODES:
            raise ValueError(
                f"unknown fwd_mode {self.fwd_mode!r}; known: {FWD_MODES}"
            )
        if self.hashed_tile not in HASHED_TILE:
            raise ValueError(
                f"unknown hashed_tile {self.hashed_tile!r}; known: {HASHED_TILE}"
            )

    @staticmethod
    def from_options(options: dict, n_dims: int) -> "HashGridConfig":
        """Build from a tcnn-style config dict (the configs' JSON)."""
        return HashGridConfig(
            n_dims=n_dims,
            n_levels=int(options["n_levels"]),
            n_features_per_level=int(options["n_features_per_level"]),
            log2_hashmap_size=int(options["log2_hashmap_size"]),
            base_resolution=int(options["base_resolution"]),
            per_level_scale=float(options["per_level_scale"]),
            fwd_mode=str(options.get("fwd_mode", "auto")),
            hashed_tile=str(options.get("hashed_tile", "off")),
            bwd_mode=str(options.get("bwd_mode", "auto")),
        )

    @cached_property
    def hashmap_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @cached_property
    def level_scales(self) -> tuple[float, ...]:
        return tuple(
            float(
                np.exp2(level * np.log2(self.per_level_scale))
                * self.base_resolution
                - 1.0
            )
            for level in range(self.n_levels)
        )

    @cached_property
    def level_resolutions(self) -> tuple[int, ...]:
        return tuple(int(np.ceil(s)) + 1 for s in self.level_scales)

    @cached_property
    def level_sizes(self) -> tuple[int, ...]:
        """Table entries per level (dense when it fits, else the hashmap)."""
        return tuple(
            _align(min(res**self.n_dims, self.hashmap_size))
            for res in self.level_resolutions
        )

    @cached_property
    def level_offsets(self) -> tuple[int, ...]:
        offs, total = [], 0
        for s in self.level_sizes:
            offs.append(total)
            total += s
        return tuple(offs)

    @cached_property
    def total_params(self) -> int:
        return sum(self.level_sizes)

    @cached_property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    def level_is_dense(self, level: int) -> bool:
        res = self.level_resolutions[level]
        return res**self.n_dims <= self.level_sizes[level]


def init_hash_table(
    cfg: HashGridConfig, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """U(-1e-4, 1e-4) feature table of shape (total_params, F), drawn from
    ``generator`` on its own device and moved to ``device``."""
    t = torch.empty(
        (cfg.total_params, cfg.n_features_per_level),
        dtype=torch.float32,
        device=generator.device,
    )
    return t.uniform_(-1e-4, 1e-4, generator=generator).to(device)


def _corner_offsets(n_dims: int) -> np.ndarray:
    """(2**D, D) binary corner offsets, x-dim fastest."""
    corners = np.stack(
        np.meshgrid(*([np.arange(2)] * n_dims), indexing="ij"), axis=-1
    ).reshape(-1, n_dims)
    return corners[:, ::-1].copy()


@functools.cache
def _corners_on(n_dims: int, device: torch.device) -> torch.Tensor:
    """``_corner_offsets(n_dims)`` on ``device``, copied there once: a
    host-to-device copy cannot run inside a CUDA graph's capture."""
    return torch.as_tensor(_corner_offsets(n_dims), device=device)


def _spatial_hash(g: torch.Tensor, n_dims: int, mod: int) -> torch.Tensor:
    """Instant-NGP spatial hash of integer coords (..., D) mod ``mod`` (a
    power of two). uint32 arithmetic in int64, masked after each product."""
    g = g.to(torch.int64)
    acc = (g[..., 0] * _PRIMES[0]) & _U32
    for d in range(1, n_dims):
        acc = acc ^ ((g[..., d] * _PRIMES[d]) & _U32)
    return acc & (mod - 1)


def _base_and_frac(x: torch.Tensor, cfg: HashGridConfig, level: int):
    """Cell base (clipped after the int cast) and in-cell fraction: two
    rounded ops ``x*scale`` then ``+ 0.5``, never a fused multiply-add."""
    scale = cfg.level_scales[level]
    res = cfg.level_resolutions[level]
    pos = x.to(torch.float32) * scale + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    base = torch.clamp(pos_grid.to(torch.int32), 0, res - 2)
    return base, frac


def _use_hashed_tiles(cfg: HashGridConfig, level: int) -> bool:
    """Whether ``level`` takes the pair-bucket hash: ``hashed_tile: "on"``,
    a 3-D grid and a hashed level. Raises where the table has fewer than 64
    entries a level, one bucket."""
    if cfg.hashed_tile != "on" or cfg.n_dims != 3 or cfg.level_is_dense(level):
        return False
    if cfg.log2_hashmap_size < 6:
        raise ValueError("hashed_tile needs 64-entry buckets (log2_hashmap_size >= 6)")
    return True


def level_indices(
    x: torch.Tensor, cfg: HashGridConfig, level: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Corner table indices and interpolation weights for one level.

    Args:
        x: (M, D) positions, nominally in [0, 1]^D (out-of-range positions
            clamp to the grid for dense levels and wrap through the hash for
            hashed levels).

    Returns:
        idx: (M, 2**D) int64 indices into the level's table slice.
        w:   (M, 2**D) interpolation weights, each the product of the
             per-dim factors taken in dim order.
    """
    res = cfg.level_resolutions[level]
    base, frac = _base_and_frac(x, cfg, level)
    corners = _corners_on(cfg.n_dims, x.device)
    g = base.to(torch.int64)[:, None, :] + corners[None, :, :]  # (M, 2^D, D)

    if cfg.level_is_dense(level):
        idx = g[..., 0]
        stride = 1
        for d in range(1, cfg.n_dims):
            stride *= res
            idx = idx + g[..., d] * stride
    elif _use_hashed_tiles(cfg, level):
        # every corner lies in the window t = base // 3, at in-window
        # offset g - 3t (0..3); the window's bucket holds its 64 entries
        # slot-major, z slowest and x fastest
        t = base.to(torch.int64) // _TILE_S
        win = g - (_TILE_S * t)[:, None, :]
        row = _TILE_W**cfg.n_dims
        bucket = _spatial_hash(t, cfg.n_dims, cfg.level_sizes[level] // row)
        slot = torch.zeros_like(win[..., 0])
        for d in reversed(range(cfg.n_dims)):
            slot = slot * _TILE_W + win[..., d]
        idx = bucket[:, None] * row + slot
    else:
        idx = _spatial_hash(g, cfg.n_dims, cfg.hashmap_size)

    cw = torch.where(corners[None] == 1, frac[:, None, :], 1.0 - frac[:, None, :])
    w = cw[..., 0]
    for d in range(1, cfg.n_dims):
        w = w * cw[..., d]
    return idx, w


def _hash_encode_exact(
    table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """The exact f32 per-corner gather (``fwd_mode="xla"``), summed over the
    corners one at a time in corner order (x bit fastest)."""
    outs = []
    for level in range(cfg.n_levels):
        idx, w = level_indices(x, cfg, level)
        feats = table[cfg.level_offsets[level] + idx].to(w.dtype)  # (M, 2^D, F)
        acc = w[:, 0, None] * feats[:, 0]
        for c in range(1, 1 << cfg.n_dims):
            acc = acc + w[:, c, None] * feats[:, c]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def resolve_fwd_mode(cfg: HashGridConfig) -> str:
    """What ``hash_encode`` computes for ``cfg``: the JAX package's TPU
    dispatch (its ``_fwd_dispatch`` with the Pallas gate ``supported``), as
    a function of the config alone; never of the device or of a build.

    Returns one of ``KERNEL_MODES`` (the kernel of that table type),
    ``"xla"`` (the exact f32 gather) or ``"xla_bf16"`` (the exact gather
    over the bf16-rounded table):

    - ``"xla"`` is exact; ``"auto"`` is ``"bf16"``;
    - ``"bf16"`` rounds the table to bf16 at every table size (beyond its
      Pallas gate the TPU gathers the bf16-cast table with XLA: the same
      numbers). The kernel takes 2 features and D in (2, 3); other grids
      gather the rounded table plainly;
    - ``"q8"`` and ``"f8"`` quantize only inside the gate (2 features, D in
      (2, 3), every level at most 2^16 entries); beyond it the TPU computes
      the exact f32 gather, and so does this: ``"f32"``;
    - ``"f32"`` is the kernel where it takes the grid, else the exact
      gather, which computes the same numbers;
    - a pair-bucket grid (``hashed_tile: "on"``) never takes a kernel:
      ``"auto"`` and ``"bf16"`` give ``"xla_bf16"``, every other mode
      ``"xla"`` (the JAX package's ``_fwd_dispatch`` keeps these grids out
      of Pallas).

    A kernel mode with more levels than the kernels take raises at the
    kernel's wrapper; no mode turns to the plain gather for that."""
    mode = "bf16" if cfg.fwd_mode == "auto" else cfg.fwd_mode
    if mode == "xla":
        return "xla"
    if cfg.hashed_tile == "on":
        return "xla_bf16" if mode == "bf16" else "xla"
    two_features_2d_or_3d = cfg.n_features_per_level == 2 and cfg.n_dims in (2, 3)
    if mode in ("q8", "f8"):
        if two_features_2d_or_3d and max(cfg.level_sizes) <= MAX_QUANTIZED_LEVEL_ENTRIES:
            return mode
        mode = "f32"
    if two_features_2d_or_3d:
        return mode
    return "xla_bf16" if mode == "bf16" else "xla"


def hash_encode(
    table: torch.Tensor,
    x: torch.Tensor,
    cfg: HashGridConfig,
    sr_noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multiresolution hash encoding of (M, D) positions -> (M, L*F).

    ``sr_noise``: optional table-shaped U[0,1) tensor enabling stochastic
    rounding of the ``q8`` quantization; ignored by every other mode.
    """
    mode = resolve_fwd_mode(cfg)
    if mode in KERNEL_MODES:
        from atmonr_tpu_torch.ops.hash_gather import hash_encode_kernel

        return hash_encode_kernel(table, x, cfg, mode, sr_noise if mode == "q8" else None)
    return hash_encode_exact(table, x, cfg, mode)


def _exact(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig, mode: str) -> torch.Tensor:
    """The exact gather of ``mode``; in ``"xla_bf16"`` over the table
    rounded to bf16, inside the span ``hash_encode.prepare`` (its count the
    table's rows), with the f32 table gradient straight through the cast
    (rounded - table is exact, so the sum is the rounded value)."""
    if mode == "xla_bf16":
        with spans.span("hash_encode.prepare", count=len(table)):
            table = table + (table.to(torch.bfloat16).to(table.dtype) - table).detach()
    return _hash_encode_exact(table, x, cfg)


def hash_encode_exact(
    table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig, mode: str
) -> torch.Tensor:
    """``hash_encode`` where ``resolve_fwd_mode`` gives ``"xla"`` or
    ``"xla_bf16"``: the exact gather, differentiated by autograd in the
    table and the positions. It opens the spans the kernel path opens
    (``ops/hash_gather.py::_HashEncode``), with the same counts:
    ``hash_encode.fwd`` (points) around the whole encode,
    ``hash_encode.prepare`` (table rows) around the bf16 rounding, and
    under autograd ``hash_encode.bwd`` (points) around its backward, on
    autograd's device thread on a card. Each call adds one to
    ``hash_encode_exact.calls[(mode, D)]``."""
    if mode not in EXACT_MODES:
        raise ValueError(f"no exact gather for mode {mode!r}; known: {EXACT_MODES}")
    key = (mode, cfg.n_dims)
    hash_encode_exact.calls[key] = hash_encode_exact.calls.get(key, 0) + 1
    if torch.is_grad_enabled() and (table.requires_grad or x.requires_grad):
        return _ExactEncode.apply(table, x, cfg, mode)
    with spans.span("hash_encode.fwd", count=len(x)):
        return _exact(table, x, cfg, mode)


hash_encode_exact.calls = {(mode, d): 0 for mode in EXACT_MODES for d in (2, 3, 4)}


class _ExactEncode(torch.autograd.Function):
    """The exact gather with its backward inside ``hash_encode.bwd``: the
    forward builds, with grad enabled, the graph autograd would build,
    over detached aliases of the table and the positions; the backward
    runs that graph's backward. The values, the gradients (bit for bit)
    and the saved tensors are autograd's through ``_exact``; the context
    holds the graph's output edge and the aliases that require grad (the
    positions' storage only where autograd would keep it too), no tensor
    of its own. First-order gradients only, as the kernel path's."""

    @staticmethod
    def forward(ctx, table, x, cfg, mode):
        with spans.span("hash_encode.fwd", count=len(x)):
            leaves = tuple(t.detach().requires_grad_(t.requires_grad) for t in (table, x))
            with torch.enable_grad():
                out = _exact(*leaves, cfg, mode)
            ctx.edge = get_gradient_edge(out)
            ctx.leaves = tuple(t if t.requires_grad else None for t in leaves)
            ctx.points = len(x)
            return out.detach()

    @staticmethod
    def backward(ctx, g):
        wanted = [t for t in ctx.leaves if t is not None]
        with spans.span("hash_encode.bwd", count=ctx.points):
            grads = iter(torch.autograd.grad(ctx.edge, wanted, g))
        return *(None if t is None else next(grads) for t in ctx.leaves), None, None
