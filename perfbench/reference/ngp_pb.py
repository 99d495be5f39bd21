"""Instant-NGP with the pair-bucket hash on the position grid's hashed
levels (``hashed_tile: "on"``), otherwise as ``ngp.py`` describes it.

The pair-bucket hash: on a hashed level of a 3-D grid the table stores
overlapped windows of 4 x 4 x 4 entries at stride 3, each window in one
bucket of 64 rows. A point's cell base ``b`` (per dim) lies in window
``t = b // 3``; its corner ``g = b + c`` (c in {0, 1}) lies at in-window
offset ``g - 3 t``, 0 to 3, so all eight corners of a cell lie in the
bucket ``spatial_hash(t) mod (level_rows / 64)``, at slot
``16 z + 4 y + x`` of their offsets (z slowest, x fastest). The spatial
hash is Instant-NGP's, ``ngp.PRIMES`` with 32-bit wraparound. Dense levels
and the 2-D surface grid keep ``ngp.py``'s indexing. The window changes
which rows a corner reads, not the table's shape, its precision or the
interpolation.

``hashing="plain"`` indexes the hashed levels with the ordinary spatial
hash of each corner instead (``ngp.py``'s): the planted fault that tells
a pair-bucket grid from a plain one. Matrix products run with TF32 off."""

from __future__ import annotations

import torch

from perfbench.reference import ngp
from perfbench.reference.nerf import float32_matmul

TILE_W, TILE_S = 4, 3  # entries a window spans per dim, and its stride
BUCKET = TILE_W**3  # rows of a bucket
HASHINGS = ("pair_bucket", "plain")


def pair_bucket(grid: ngp.Grid, level: int) -> bool:
    """Whether ``level`` of ``grid`` takes the pair-bucket hash: a hashed
    level of a 3-D grid."""
    return grid.dims == 3 and grid.resolution(level) ** 3 > grid.sizes[level]


def corners_and_weights(x: torch.Tensor, grid: ngp.Grid, level: int, hashing: str):
    """Table rows (M, 8) of a level's cell corners (x bit fastest) and
    their weights, the hashed 3-D levels indexed by ``hashing``."""
    idx, w = ngp.corners_and_weights(x, grid, level)
    if hashing == "plain" or not pair_bucket(grid, level):
        return idx, w
    res = grid.resolution(level)
    cell = torch.floor(x * grid.scale(level) + 0.5)
    base = torch.clamp(cell.to(torch.int32), 0, res - 2).to(torch.int64)
    window = torch.div(base, TILE_S, rounding_mode="floor")
    bits = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)], device=x.device)
    offset = base[:, None, :] - TILE_S * window[:, None, :] + bits[None]  # (M, 8, 3), 0..3
    slot = offset[..., 0] + TILE_W * offset[..., 1] + TILE_W * TILE_W * offset[..., 2]
    h = window[:, 0] * ngp.PRIMES[0] & 0xFFFFFFFF
    for d in (1, 2):
        h = h ^ (window[:, d] * ngp.PRIMES[d] & 0xFFFFFFFF)
    bucket = h & (grid.sizes[level] // BUCKET - 1)
    return grid.offsets[level] + bucket[:, None] * BUCKET + slot, w


def encode(table: torch.Tensor, x: torch.Tensor, grid: ngp.Grid, fmt: str, hashing: str,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """``ngp.encode`` with the rows of ``corners_and_weights``: the corner
    sum over the stored table, differentiable in the float32 table."""
    with torch.no_grad():
        decoded, scale = ngp.stored_table(table, grid, fmt, noise)
    outs = []
    for level in range(grid.levels):
        idx, w = corners_and_weights(x, grid, level, hashing)
        with torch.no_grad():
            q = decoded[idx]
            acc = w[:, 0, None] * q[:, 0]
            for c in range(1, idx.shape[1]):
                acc = acc + w[:, c, None] * q[:, c]
            if scale is not None:
                acc = acc * scale[level]
        if torch.is_grad_enabled() and table.requires_grad:
            # the stored table's value, the float32 table's gradient
            exact = (w[..., None] * table[idx]).sum(1)
            acc = acc + (exact - exact.detach())
        outs.append(acc)
    return torch.cat(outs, -1)


class Model(ngp.Model):
    """``ngp.Model`` whose position grid is indexed by ``hashing``
    (``"pair_bucket"`` where its configuration sets ``hashed_tile: "on"``,
    else ``"plain"``), with TF32 off in its products."""

    def __init__(self, pipeline_cfg: dict, scene, table_format: str | None = None,
                 hashing: str = "pair_bucket"):
        super().__init__(pipeline_cfg, scene, table_format)
        if hashing not in HASHINGS:
            raise ValueError(f"unknown hashing {hashing!r}; known: {HASHINGS}")
        tiled = pipeline_cfg["instant_ngp"]["encoding"].get("hashed_tile", "off") == "on"
        self.hashing = hashing if tiled else "plain"

    def density(self, p: dict, x, noise=None):
        with float32_matmul():
            feats = encode(p["pos_table"], x, self.pos, self.fmt(self.pos), self.hashing, noise)
            return ngp.mlp(self.weights(p, "pos_mlp"), feats)

    def render(self, p: dict, rays, draws: dict, occ):
        with float32_matmul():
            return super().render(p, rays, draws, occ)


AdamW = ngp.AdamW
