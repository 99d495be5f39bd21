"""Spherical-Earth helpers for the global visualization grid: a numpy
copy of the JAX package's ``geo/spherical.py`` (which the extraction calls
with ``xp=np``)."""

from __future__ import annotations

import numpy as np

from atmonr_tpu_torch.geo.wgs84 import WGS_84_A, WGS_84_B

EARTH_RADIUS = 6.378e6  # meters


def wgs_84_to_spherical(xyz):
    """Rescale WGS-84 ECEF points onto a sphere of EARTH_RADIUS."""
    z = xyz[..., 2] * (WGS_84_A / WGS_84_B)
    xyz_s = np.concatenate([xyz[..., :2], z[..., None]], axis=-1)
    return xyz_s * (EARTH_RADIUS / WGS_84_A)


def spherical_to_wgs84(xyz):
    """Inverse of :func:`wgs_84_to_spherical`."""
    xyz_w = xyz * (WGS_84_A / EARTH_RADIUS)
    z = xyz_w[..., 2] * (WGS_84_B / WGS_84_A)
    return np.concatenate([xyz_w[..., :2], z[..., None]], axis=-1)


def stretch_above_sea_level(xyz, stretch: float):
    """Radially stretch points above sea level by ``stretch`` (atmosphere
    exaggeration for global visualization)."""
    radii = np.sqrt(np.sum(xyz**2, axis=-1))
    above = radii > EARTH_RADIUS
    rad_stretch = np.where(above, (radii - EARTH_RADIUS) * stretch + EARTH_RADIUS, radii)
    factor = np.where(above, rad_stretch / radii, np.ones_like(radii))
    return xyz * factor[..., None]
