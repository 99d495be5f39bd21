"""Ray-march samplers: stratified bins and the piecewise-constant inverse
CDF behind the occupancy grid.

Counterpart of the JAX package's ``ops/samplers.py``. Randomness comes in
as explicit draw tensors (``None`` selects the deterministic midpoint
variant used by eval and the parity tests); callers make the draws from a
``torch.Generator``. ``sample_pdf`` and ``append_heights`` are still to be
ported with the NeRF pipeline.
"""

from __future__ import annotations

from typing import Mapping

import torch


def _rank_right(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Batched ``searchsorted(cdf, u, side="right")``: #{j: cdf[j] <= u}.

    Args: cdf (..., n_bins+1) ascending; u (..., n_samples).
    Returns (..., n_samples) int64."""
    return torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)


def _unit_bins(n_bins: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The left edges of ``n_bins`` equal bins of [0, 1], as XLA evaluates
    ``jnp.linspace(0, 1, n+1)``: ``i * (1/n)``, the reciprocal rounded to
    ``dtype`` first. (``torch.linspace`` computes its upper half from the
    end, and a division ``i / n`` rounds once; both differ in the last ulp
    for some ``n``, and an ulp can move a sample across a hash cell.)"""
    return torch.arange(n_bins, dtype=dtype, device=device) * (1.0 / n_bins)


def sample_uniform_bins(
    ray_batch: Mapping[str, torch.Tensor],
    n_bins: int = 64,
    t_in_bin: torch.Tensor | None = None,
):
    """Stratified sampling: one sample per evenly-sized bin along rays.

    Args:
        ray_batch: dict with "origin" (B, 3), "dir" (B, 3), "len" (B,).
        n_bins: number of stratification bins.
        t_in_bin: (B, n_bins) U[0,1) positions within the bins, or None for
            the bin midpoints.

    Returns:
        pts: (B, n_bins, 3) sampled points. z_vals: (B, n_bins) distances.
    """
    origin = ray_batch["origin"]
    bins = _unit_bins(n_bins, origin.dtype, origin.device)[None]
    if t_in_bin is None:
        z_unit = bins + 0.5 / n_bins
    else:
        z_unit = bins + t_in_bin / n_bins
    z_vals = z_unit * ray_batch["len"][:, None]
    pts = origin[:, None] + ray_batch["dir"][:, None] * z_vals[..., None]
    return pts, z_vals


def sample_piecewise(
    ray_batch: Mapping[str, torch.Tensor],
    weights: torch.Tensor,
    n_samples: int,
    jitter: torch.Tensor | None = None,
):
    """Inverse-CDF sampling from a piecewise-constant pdf over uniform bins.

    ``weights`` are bin masses over ``n_bins`` equal subdivisions of the
    full [0, len] extent; exactly ``n_samples`` sorted samples come back,
    stratified in CDF space (one per quantile bin).

    Args:
        ray_batch: dict with "origin" (B, 3), "dir" (B, 3), "len" (B,).
        weights: (B, n_bins) nonnegative bin masses, not all zero.
        n_samples: samples to draw per ray.
        jitter: (B, n_samples) draws in [0, 1/n_samples) added to the
            quantiles, or None for the quantile midpoints.

    Returns:
        pts: (B, n_samples, 3). z_vals: (B, n_samples), sorted ascending.
    """
    b, n_bins = weights.shape
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat(
        [torch.zeros((b, 1), dtype=pdf.dtype, device=pdf.device), torch.cumsum(pdf, dim=-1)],
        dim=-1,
    )  # (B, n_bins + 1), cdf[..., -1] == 1

    quantiles = torch.arange(n_samples, dtype=cdf.dtype, device=cdf.device) / n_samples
    if jitter is None:
        u = (quantiles[None] + 0.5 / n_samples).expand(b, n_samples)
    else:
        u = quantiles[None] + jitter

    inds = _rank_right(cdf, u)
    below = torch.clamp(inds - 1, 0, n_bins - 1)
    cdf_b = torch.gather(cdf[:, :-1], 1, below)
    pdf_b = torch.gather(pdf, 1, below)
    t_in_bin = (u - cdf_b) / torch.clamp(pdf_b, min=1e-12)
    z_unit = (below.to(cdf.dtype) + torch.clamp(t_in_bin, 0.0, 1.0)) / n_bins
    z_vals = z_unit * ray_batch["len"][:, None]
    pts = ray_batch["origin"][:, None] + ray_batch["dir"][:, None] * z_vals[..., None]
    return pts, z_vals
