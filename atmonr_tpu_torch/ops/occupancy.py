"""Occupancy grid: density-driven sample placement for Instant-NGP.

Counterpart of the JAX package's ``ops/occupancy.py``. A dense (Rx, Ry, Rz)
f32 grid over the preprocessed unit cube (post point-preprocessor, post
[0,1] remap, pre altitude compression) tracks the field. The update is a
full re-evaluation of the density branch at (jittered) cell centers,
``occ = max(occ * decay, sigma)``; probing is a flat gather.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OccupancyConfig:
    """Static occupancy-grid configuration."""

    resolution: tuple[int, int, int] = (64, 64, 32)
    n_probe: int = 64
    n_fine: int = 32
    update_every: int = 16
    decay: float = 0.8
    floor: float = 0.05

    @staticmethod
    def from_options(options: dict) -> "OccupancyConfig":
        res = options.get("resolution", (64, 64, 32))
        return OccupancyConfig(
            resolution=(int(res[0]), int(res[1]), int(res[2])),
            n_probe=int(options.get("n_probe", 64)),
            n_fine=int(options.get("n_fine", 32)),
            update_every=int(options.get("update_every", 16)),
            decay=float(options.get("decay", 0.8)),
            floor=float(options.get("floor", 0.05)),
        )

    @property
    def num_cells(self) -> int:
        rx, ry, rz = self.resolution
        return rx * ry * rz


def init_grid(cfg: OccupancyConfig, device: torch.device) -> torch.Tensor:
    """All-ones grid -> uniform sampling until the first density update."""
    return torch.ones(cfg.resolution, dtype=torch.float32, device=device)


def cell_points(
    cfg: OccupancyConfig, device: torch.device, jitter: torch.Tensor | None = None
) -> torch.Tensor:
    """(num_cells, 3) unit-cube points, one per cell in (x, y, z) row-major
    order: ``jitter`` (num_cells, 3) U[0,1) places each within its cell,
    None takes the cell centers."""
    rx, ry, rz = cfg.resolution
    ii, jj, kk = torch.meshgrid(
        torch.arange(rx, dtype=torch.float32, device=device),
        torch.arange(ry, dtype=torch.float32, device=device),
        torch.arange(rz, dtype=torch.float32, device=device),
        indexing="ij",
    )
    base = torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], dim=-1)
    t = 0.5 if jitter is None else jitter
    return (base + t) / base.new_tensor([rx, ry, rz])


def update_grid(
    occ: torch.Tensor, sigma: torch.Tensor, cfg: OccupancyConfig
) -> torch.Tensor:
    """EMA-max update from a full re-evaluation in ``cell_points`` order."""
    sigma = torch.reshape(sigma.to(torch.float32), cfg.resolution)
    return torch.maximum(occ * cfg.decay, sigma)


def probe(occ: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Grid values at unit-cube positions ``u`` (..., 3) -> (...)."""
    _, ry, rz = occ.shape
    i, j, k = (
        torch.clamp(torch.floor(u[..., d] * float(r)).to(torch.int64), 0, r - 1)
        for d, r in enumerate(occ.shape)
    )
    return occ.reshape(-1)[(i * ry + j) * rz + k]


def probe_weights(
    occ: torch.Tensor, u: torch.Tensor, cfg: OccupancyConfig
) -> torch.Tensor:
    """Per-probe sampling weights: grid values normalized by the per-ray max
    plus an exploration floor (keeps every region minimally sampled)."""
    w = probe(occ, u)
    w = w / (torch.amax(w, dim=-1, keepdim=True) + 1e-12)
    return w + cfg.floor
