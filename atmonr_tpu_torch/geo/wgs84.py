"""WGS-84 geospatial math for multi-angle satellite ray construction.

The part of the JAX package's ``geo/wgs84.py`` that the inference slice
needs, with the same reference frames:

1. WGS-84 ellipsoid, horizontal coordinates (lat/lon/alt), EPSG:4326.
2. WGS-84 ellipsoid, Cartesian coordinates (ECEF), EPSG:4978.
3. Normalized Cartesian scene coordinates: +X=East, +Y=North, +Z=up at the
   scene-center pixel, max-min normalized to [-1, 1].

Rays are built once on the host in float64 numpy (meter accuracy).
``cartesian_to_horizontal`` is written against an array namespace ``xp`` so
the same formula also runs on device tensors (``xp=torch``) in float32 for
the per-step point preprocessor.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

# WGS-84 constants
WGS_84_A = 6378137.0  # semimajor axis [m]
WGS_84_B = 6356752.314245  # semiminor axis [m]
WGS_84_E = (WGS_84_A**2 - WGS_84_B**2) / (WGS_84_A**2)  # first eccentricity squared
WGS_84_E2 = (WGS_84_A**2 - WGS_84_B**2) / (WGS_84_B**2)  # second eccentricity squared


def horizontal_to_cartesian(lat, lon, alt):
    """WGS-84 geographic (lat, lon, alt[m]) -> ECEF Cartesian (x, y, z)."""
    lat = lat * (math.pi / 180.0)
    lon = lon * (math.pi / 180.0)
    sin_lat = np.sin(lat)
    n = WGS_84_A / np.sqrt(1.0 - (WGS_84_E * sin_lat**2))
    cos_lat = np.cos(lat)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - WGS_84_E) + alt) * sin_lat
    return x, y, z


def cartesian_to_horizontal(x, y, z, *, xp: Any = np):
    """ECEF Cartesian (x, y, z) -> WGS-84 geographic (lat, lon, alt[m]).

    Bowring's (1976) first-order approximation with the altitude solve
    ``alt = x / (cos(lat) cos(lon)) - N``. ``xp`` is ``numpy`` (float64 on
    the host, exact to ~mm) or ``torch`` (float32 on the device, with a
    ~1-6 m altitude error floor from cancelling two ~6.4e6 m values).
    """
    lon = xp.arctan2(y, x)
    d = xp.sqrt(x**2 + y**2)  # horizontal component
    # parametric latitude (first Bowring iteration)
    u = xp.arctan2(z / d, xp.zeros_like(x) + (WGS_84_A / WGS_84_B))
    sin_u = xp.sin(u)
    cos_u = xp.cos(u)
    lat = xp.arctan2(
        z + (WGS_84_E2 * WGS_84_B) * sin_u**3,
        d - (WGS_84_E * WGS_84_A) * cos_u**3,
    )
    n = WGS_84_A / xp.sqrt(1.0 - (WGS_84_E * xp.sin(lat) ** 2))
    alt = x / (xp.cos(lat) * xp.cos(lon)) - n
    return lat * (180.0 / math.pi), lon * (180.0 / math.pi), alt


def horizontal_coords_to_rot_mtx(theta, phi):
    """(..., 3, 3) rotation matrices from (zenith, azimuth) in degrees."""
    theta = -theta * (math.pi / 180.0)
    phi = -phi * (math.pi / 180.0)
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_p, cos_p = np.sin(phi), np.cos(phi)
    zeros = np.zeros_like(theta)
    row0 = np.stack([cos_p, -sin_p * cos_t, sin_p * sin_t], axis=-1)
    row1 = np.stack([sin_p, cos_p * cos_t, -cos_p * sin_t], axis=-1)
    row2 = np.stack([zeros, sin_t, cos_t], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def horizontal_coords_to_dirvecs(theta, phi):
    """Direction vectors (+z = up frame) from (zenith, azimuth) in degrees:
    the rotation matrix applied to the unit +z vector."""
    shp = theta.shape
    rot = horizontal_coords_to_rot_mtx(np.reshape(theta, (-1,)), np.reshape(phi, (-1,)))
    return np.reshape(rot[..., :, 2], tuple(shp) + (3,))


def compose_dirs_and_surface_normals(dirs, lat, lon):
    """Rotate +z=up-frame direction vectors into the WGS-84 Cartesian frame:
    R(90-lat, 90-lon) after a 180-degree z-rotation."""
    rot = horizontal_coords_to_rot_mtx(90.0 - lat, 90.0 - lon)
    d = np.stack([-dirs[..., 0], -dirs[..., 1], dirs[..., 2]], axis=-1)
    return np.einsum("...ij,...j->...i", rot, d)


def get_rays(
    lat,
    lon,
    alt,
    thetav,
    phiv,
    ray_origin_height: float,
    tol: float = 10.0,
    max_iters: int = 20,
):
    """Rays (origin, direction, length) from satellite viewing geometry.

    P pixels x A angles -> flattened (P*A, 3) float32 origins at
    ``ray_origin_height`` above the ellipsoid, unit directions from the top
    of the atmosphere toward the surface, and segment lengths. The origin
    height is a fixed-point iteration on the ray length, run on float64
    numpy until every ray is within ``tol`` meters; the surface points are
    rounded through float32 first, as the reference does.
    """
    f64, f32 = np.float64, np.float32
    x, y, z = horizontal_to_cartesian(
        lat.astype(f64), lon.astype(f64), alt.astype(f64)
    )
    xyz = np.stack([x, y, z], axis=-1).astype(f32).astype(f64)

    dirs = horizontal_coords_to_dirvecs(thetav.astype(f64), phiv.astype(f64))
    comp_dirs = compose_dirs_and_surface_normals(
        np.reshape(dirs, (-1, 3)),
        np.reshape(lat, (-1,)).astype(f64),
        np.reshape(lon, (-1,)).astype(f64),
    )
    # flip so the top of the atmosphere is the origin
    comp_dirs = -np.reshape(comp_dirs, dirs.shape)

    # initial guess: straight-line length via the view zenith
    lens = ((ray_origin_height - alt) / np.cos(thetav * (math.pi / 180.0))).astype(f64)
    lens = np.reshape(lens, comp_dirs.shape[:-1])

    def _alt_at(lens_):
        xyz2 = xyz - lens_[..., None] * comp_dirs
        _, _, alt_check = cartesian_to_horizontal(xyz2[..., 0], xyz2[..., 1], xyz2[..., 2])
        return alt_check

    alt_check = _alt_at(lens)
    err = np.abs(ray_origin_height - alt_check)
    iters = 0
    while iters < max_iters and np.any(err > tol):
        lens = lens * ray_origin_height / alt_check
        alt_check = _alt_at(lens)
        err = np.abs(ray_origin_height - alt_check)
        iters += 1

    lens = lens.astype(f32).astype(f64)
    origins = np.reshape(xyz - comp_dirs * lens[..., None], (-1, 3))
    comp_dirs = np.reshape(comp_dirs, (-1, 3))
    return (
        origins.astype(f32),
        comp_dirs.astype(f32),
        np.reshape(lens, (-1,)).astype(f32),
    )


def filter_rays(ray_origin, ray_dir, ray_rad):
    """Mask of rays with valid origin, direction, and radiance."""
    pos_nan = np.any(np.isnan(ray_origin), axis=1)
    dir_nan = np.any(np.isnan(ray_dir), axis=1)
    rad_nan = np.isnan(ray_rad)
    return (~pos_nan) & (~dir_nan) & (~rad_nan)


def normalize_rays(ray_origin, ray_dir, ray_len):
    """Normalize ray origins into [-1, 1]^3 -> (origins_norm, scale, offset).

    ``scale`` is the half-extent of the largest axis (a Python float);
    ``offset`` the (3,) float64 box center."""
    xyz = np.concatenate([ray_origin, ray_origin + ray_dir * ray_len[:, None]], axis=0)
    xyz_max = np.max(xyz, axis=0).astype(np.float64)
    xyz_min = np.min(xyz, axis=0).astype(np.float64)
    scale = float(np.max(xyz_max - xyz_min) / 2.0)
    offset = (xyz_max + xyz_min) / 2.0
    origin_norm = np.clip((ray_origin - offset) / scale, -1.0, 1.0).astype(np.float32)
    return origin_norm, scale, offset
