"""Beer-Lambert volume compositing along viewing rays (counterpart of the
JAX package's ``ops/compositor.py``): Voronoi (midpoint) deltas with a zero
prepended and the final z appended, ``alpha = 1 - exp(-sigma * delta)``,
transmittance by a cumulative product with a 1e-10 guard."""

from __future__ import annotations

import torch


def render(z_vals: torch.Tensor, color: torch.Tensor, sigma: torch.Tensor):
    """Composite sampled colors and densities along rays.

    Args:
        z_vals: (B, N) distances of samples along each ray, in km.
        color:  (B, N, C) colors at sampled locations.
        sigma:  (B, N, 1 or C) extinction densities at sampled locations.

    Returns:
        color_map: (B, C) composited color per ray.
        alpha:     (B, N, C) per-sample attenuation.
        weights:   (B, N, 1 or C) compositing weights.
    """
    if not (z_vals.ndim == 2 and color.ndim == 3 and sigma.ndim == 3):
        raise ValueError("render takes z_vals (B, N), color and sigma (B, N, C)")
    z_vals = z_vals.to(color.dtype)

    z_mid = (z_vals[..., :-1] + z_vals[..., 1:]) * 0.5
    z_mid = torch.cat([z_vals[..., :1] * 0, z_mid, z_vals[..., -1:]], dim=-1)
    delta = torch.diff(z_mid, dim=-1)[..., None]

    alpha = 1.0 - torch.exp(-sigma * delta)
    ones = torch.ones(
        (alpha.shape[0], 1, alpha.shape[2]), dtype=alpha.dtype, device=alpha.device
    )
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=1), dim=1)[:, :-1]
    weights = alpha * trans
    color_map = torch.sum(color * weights, dim=1)
    return color_map, alpha, weights


def render_with_surface(z_vals, color, sigma, color_surf):
    """Composite with an opaque surface behind the volume, which adds
    ``prod(1 - alpha) * color_surf``.

    Returns:
        (color_map, alpha, weights, color_map_atmo, color_map_surf)
    """
    color_map_atmo, alpha, weights = render(z_vals, color, sigma)
    color_map_surf = torch.prod(1.0 - alpha, dim=1) * color_surf
    color_map = color_map_atmo + color_map_surf
    return color_map, alpha, weights, color_map_atmo, color_map_surf
