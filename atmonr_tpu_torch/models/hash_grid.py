"""Multiresolution hash-grid encoding (Instant-NGP) in PyTorch.

Counterpart of the JAX package's ``models/hash_grid.py``:

- L levels of feature grids with geometrically growing resolution
  ``scale_l = base * growth**l - 1``, ``res_l = ceil(scale_l) + 1``;
- levels whose dense vertex count fits in the 2**log2_hashmap_size table are
  indexed densely, larger levels via the spatial hash
  ``(x*1) xor (y*2654435761) xor (z*805459861) mod T`` (uint32 wraparound);
- D-linear interpolation of the 2**D corner feature vectors;
- features initialized U(-1e-4, 1e-4);
- all levels in one flat (total_params, F) table.

Two forward modes are ported. ``"xla"`` is the exact f32 per-corner gather,
plain tensor indexing (the JAX package also computes it outside Pallas);
autograd differentiates it, the table and the positions. ``"q8"`` quantizes
each level to int8 and gathers with the CUDA kernel of
``ops/hash_gather.py`` (its plain version on CPU tensors); its table
gradient is the CUDA kernel of ``ops/hash_bwd.py``. Every other mode
raises: the Pallas kernel's bf16/f32/f8 modes (``"auto"`` is bf16) are still
to be ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

# spatial-hash primes, per the Instant-NGP paper (first dim intentionally 1)
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF

FWD_MODES = ("xla", "q8")
# every value the JAX package accepts; the port computes one gradient for all
BWD_MODES = ("auto", "f32", "bf16", "sort")


def _align(n: int, m: int = 8) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class HashGridConfig:
    """Static configuration of a multiresolution hash grid.

    ``fwd_mode`` is validated at construction: ``"q8"`` or ``"xla"``.
    ``hashed_tile: "on"`` (the pair-bucket hash, a different model) is not
    ported and raises. ``bwd_mode`` is validated too: the port computes
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
            raise NotImplementedError(
                f"fwd_mode {self.fwd_mode!r} is not ported: atmonr_tpu_torch "
                "runs 'q8' (the int8 CUDA kernel) and 'xla' (the exact f32 "
                "gather). The Pallas kernel's bf16, f32 and f8 modes ('auto' "
                "is bf16) are ROADMAP.md queue 2, 'K1 other modes'."
            )
        if self.hashed_tile != "off":
            raise NotImplementedError(
                f"hashed_tile {self.hashed_tile!r} is not ported: the "
                "pair-bucket hash is ROADMAP.md queue 1, 'Reference-capacity "
                "configs'."
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
    corners = torch.as_tensor(_corner_offsets(cfg.n_dims), device=x.device)
    g = base.to(torch.int64)[:, None, :] + corners[None, :, :]  # (M, 2^D, D)

    if cfg.level_is_dense(level):
        idx = g[..., 0]
        stride = 1
        for d in range(1, cfg.n_dims):
            stride *= res
            idx = idx + g[..., d] * stride
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


def hash_encode(
    table: torch.Tensor,
    x: torch.Tensor,
    cfg: HashGridConfig,
    sr_noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multiresolution hash encoding of (M, D) positions -> (M, L*F).

    ``sr_noise``: optional table-shaped U[0,1) tensor enabling stochastic
    rounding of the ``q8`` quantization; ignored by ``"xla"``.
    """
    if cfg.fwd_mode == "q8":
        from atmonr_tpu_torch.ops.hash_gather import hash_encode_q8

        return hash_encode_q8(table, x, cfg, sr_noise)
    return _hash_encode_exact(table, x, cfg)
