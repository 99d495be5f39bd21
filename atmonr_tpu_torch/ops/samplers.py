"""Ray-march samplers: stratified bins, the inverse CDF of coarse
compositing weights (importance sampling), the piecewise-constant
inverse CDF behind the occupancy grid and the surface-biased trapezoid
pdf; and ``append_heights``, the ellipsoidal height as a 4th input
channel.

Counterpart of the JAX package's ``ops/samplers.py``. Randomness comes in
as explicit draw tensors (``None`` selects the deterministic midpoint
variant used by eval and the parity tests); callers make the draws from a
``torch.Generator``.
"""

from __future__ import annotations

import functools
from typing import Mapping

import torch

from atmonr_tpu_torch.geo.wgs84 import cartesian_to_horizontal


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


def sample_pdf(
    ray_batch: Mapping[str, torch.Tensor],
    pdf_discrete: torch.Tensor,
    z_vals_c: torch.Tensor,
    n_samples: int = 128,
    u: torch.Tensor | None = None,
):
    """Importance-sample the coarse density pdf along each ray.

    Inverts the discrete CDF built from the coarse compositing weights (the
    first and last weight trimmed, 1e-8 added to each), merges the new
    samples with the coarse depths and sorts. The bin width carries no
    gradient.

    Args:
        ray_batch: dict with "origin" (B, 3), "dir" (B, 3), "len" (B,).
        pdf_discrete: (B, N_c, 1) coarse weights.
        z_vals_c: (B, N_c) coarse sample distances.
        n_samples: number of fine samples to draw.
        u: (B, n_samples) U[0,1) quantiles, or None for the evenly spaced
            midpoints ``(i + 0.5) / n_samples``.

    Returns:
        pts: (B, N_c + n_samples, 3). z_vals: (B, N_c + n_samples), sorted.
    """
    w = pdf_discrete[:, 1:-1, 0] + 1e-8
    pdf = w / torch.sum(w, dim=1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=1)

    if u is None:
        u = (torch.arange(n_samples, dtype=cdf.dtype, device=cdf.device) + 0.5) / n_samples
        u = u.expand(cdf.shape[0], n_samples)
    inds = _rank_right(cdf, u)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    z_vals_mid = 0.5 * (z_vals_c[..., 1:] + z_vals_c[..., :-1])
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(z_vals_mid, -1, below)
    bins_a = torch.gather(z_vals_mid, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    t_in_bin = (u - cdf_b) / denom
    samples = bins_b + t_in_bin * (bins_a - bins_b).detach()

    z_vals = torch.sort(torch.cat([z_vals_c, samples], dim=-1), dim=-1).values
    pts = ray_batch["origin"][:, None] + ray_batch["dir"][:, None] * z_vals[..., None]
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


def sample_biased_bins(
    ray_batch: Mapping[str, torch.Tensor],
    n_bins: int,
    ray_origin_height: float,
    alpha: float,
    t_in_bin: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Surface-biased stratified sampling with a trapezoid pdf.

    The unnormalized pdf rises linearly from ``alpha`` at the ray origin to
    1 at the surface and is constant beyond; ``alpha == 1`` is the uniform
    case. One sample per bin of the flat [0, 1] parameter, mapped through
    the trapezoid's inverse CDF. Part of the public sampler API; no
    pipeline uses it.

    Args:
        ray_batch: dict with "origin" (B, 3), "dir" (B, 3), "len" (B,).
        n_bins: number of stratification bins.
        ray_origin_height: the scene's ray-origin height (unused by the
            math, as in the JAX package).
        alpha: the pdf at the ray origin, in [0, 1].
        t_in_bin: (B, n_bins) U[0,1) positions within the bins; or drawn
            from ``generator``; the bin midpoints when both are None.

    Returns:
        pts: (B, n_bins, 3) sampled points. z_vals: (B, n_bins) distances.
    """
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must lie in [0, 1], got {alpha}")
    origin = ray_batch["origin"]
    b = origin.shape[0]
    if generator is not None:
        if t_in_bin is not None:
            raise ValueError("pass t_in_bin or a generator, not both")
        t_in_bin = torch.rand((b, n_bins), generator=generator, device=generator.device,
                              dtype=origin.dtype).to(origin.device)
    bins = _unit_bins(n_bins, origin.dtype, origin.device)[None]
    z_flat = (bins + (0.5 if t_in_bin is None else t_in_bin) / n_bins).expand(b, n_bins)
    if alpha == 1.0:
        z_vals = torch.clamp(z_flat, max=1.0)
    else:
        norm_term = (alpha + 1.0) / 2.0
        inv_cdf = (
            -alpha + torch.sqrt(alpha**2 + 2.0 * (1.0 - alpha) * norm_term * z_flat)
        ) / (1.0 - alpha)
        z_vals = torch.where(z_flat <= 1.0, inv_cdf, torch.ones_like(z_flat))
    z_vals = z_vals * ray_batch["len"][:, None]
    pts = origin[:, None] + ray_batch["dir"][:, None] * z_vals[..., None]
    return pts, z_vals


@functools.cache
def _constant(values: tuple[float, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values`` as a ``dtype`` tensor on ``device``, copied there once: a
    host-to-device copy cannot run inside a CUDA graph's capture."""
    return torch.tensor(values, dtype=dtype, device=device)


def append_heights(
    pts: torch.Tensor, ray_origin_height: float, scale: float, offset
) -> torch.Tensor:
    """Append the normalized ellipsoidal height as a 4th channel of (..., 3)
    points: un-normalize to ECEF (``pts * scale + offset``), convert to
    (lat, lon, alt) in the points' own dtype and divide the altitude by
    ``ray_origin_height``. In float32 the altitude carries the conversion's
    ~1-6 m error floor (``geo/wgs84.py::cartesian_to_horizontal``)."""
    offset = _constant(tuple(torch.as_tensor(offset, dtype=torch.float64).tolist()),
                       pts.dtype, pts.device)
    xyz = pts * scale + offset
    _, _, alt = cartesian_to_horizontal(xyz[..., 0], xyz[..., 1], xyz[..., 2], xp=torch)
    return torch.cat([pts, (alt / ray_origin_height)[..., None]], dim=-1)
