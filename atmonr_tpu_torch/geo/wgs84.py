"""WGS-84 geospatial math for multi-angle satellite ray construction.

A numpy copy of the JAX package's ``geo/wgs84.py``, with the same
reference frames:

1. WGS-84 ellipsoid, horizontal coordinates (lat/lon/alt), EPSG:4326.
2. WGS-84 ellipsoid, Cartesian coordinates (ECEF), EPSG:4978.
3. Normalized Cartesian scene coordinates: +X=East, +Y=North, +Z=up at the
   scene-center pixel, max-min normalized to [-1, 1].

Rays and extraction grids are built once on the host in float64 numpy
(meter accuracy; the Vincenty solves are genuine ``while`` loops).
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
WGS_84_F = (WGS_84_A - WGS_84_B) / WGS_84_A  # flattening


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


def horizontal_grid_terms(lat, lon) -> tuple[np.ndarray, ...]:
    """The per-pixel terms of ``horizontal_grid_to_cartesian`` of a
    lat/lon grid [deg], in float64: ``(n, n (1 - e^2), cos lat, cos lon,
    sin lon, sin lat)``, ``n`` the prime vertical radius of curvature."""
    lat = np.asarray(lat, np.float64) * (math.pi / 180.0)
    lon = np.asarray(lon, np.float64) * (math.pi / 180.0)
    sin_lat = np.sin(lat)
    n = WGS_84_A / np.sqrt(1.0 - (WGS_84_E * sin_lat**2))
    return n, n * (1.0 - WGS_84_E), np.cos(lat), np.cos(lon), np.sin(lon), sin_lat


def horizontal_grid_to_cartesian(lat, lon, alt) -> np.ndarray:
    """A horizontal (H, W) lat/lon grid [deg] times an (na,) altitude
    ladder [m] -> (H, W, na, 3) float64 ECEF, C-contiguous.

    Bit-equal to ``horizontal_to_cartesian`` of the grid repeated over the
    ladder, every input cast to float64: each point goes through the same
    float64 operations in the same order, but the trigonometry and ``n``
    are computed once a pixel (``horizontal_grid_terms``) and broadcast over
    the ladder, and the three coordinates are written straight into the
    output. The plain version of ``native.horizontal_grid_to_cartesian``.
    """
    n, nz, cos_lat, cos_lon, sin_lon, sin_lat = horizontal_grid_terms(lat, lon)
    alt = np.asarray(alt, np.float64)
    out = np.empty(n.shape + alt.shape + (3,), np.float64)
    tmp = np.empty(n.shape + alt.shape, np.float64)
    np.add(n[..., None], alt, out=tmp)
    np.multiply(tmp, cos_lat[..., None], out=tmp)
    np.multiply(tmp, cos_lon[..., None], out=out[..., 0])
    np.multiply(tmp, sin_lon[..., None], out=out[..., 1])
    np.add(nz[..., None], alt, out=tmp)
    np.multiply(tmp, sin_lat[..., None], out=out[..., 2])
    return out


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


def dirvecs_to_horizontal_coords(dirs):
    """Direction vectors -> (zenith [0, 360), azimuth [-180, 180)) in
    degrees. As in the reference, the horizontal norm is ONE scalar over
    the first two components of every vector (a flattened norm)."""
    dirs = np.reshape(dirs, (-1, 3))
    horiz_norm = np.sqrt(np.sum(dirs[..., :2] ** 2))
    theta = np.arctan2(horiz_norm, dirs[..., 2])
    phi = -np.arctan2(dirs[..., 0], -dirs[..., 1])
    theta = (theta * (180.0 / math.pi)) % 360.0
    phi = (phi * (180.0 / math.pi)) % 360.0 - 180.0
    return theta, phi


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


def vincenty_distance(latlon1, latlon2, tol: float = 1e-12, max_iters: int = 10):
    """Geodesic distance on the WGS-84 ellipsoid (Vincenty's inverse
    problem).

    ``latlon1`` / ``latlon2`` are (lat, lon) tuples or (2, ...) arrays in
    degrees. Returns (distance [m], forward azimuth at the start [deg],
    forward azimuth at the destination [deg]). Iterates until no lambda
    moves by more than ``tol``; raises ``Warning`` after ``max_iters``
    iterations that did not converge, as the reference does.
    """
    lat1, lat2 = latlon1[0] * (math.pi / 180.0), latlon2[0] * (math.pi / 180.0)
    lon1, lon2 = latlon1[1] * (math.pi / 180.0), latlon2[1] * (math.pi / 180.0)
    u1 = np.arctan((1.0 - WGS_84_F) * np.tan(lat1))
    u2 = np.arctan((1.0 - WGS_84_F) * np.tan(lat2))
    big_l = lon2 - lon1

    sin_u1, cos_u1 = np.sin(u1), np.cos(u1)
    sin_u2, cos_u2 = np.sin(u2), np.cos(u2)

    def _iterate(lambd):
        sin_l, cos_l = np.sin(lambd), np.cos(lambd)
        sin_sigma = np.sqrt(
            (cos_u2 * sin_l) ** 2 + (cos_u1 * sin_u2 - sin_u1 * cos_u2 * cos_l) ** 2
        )
        cos_sigma = sin_u1 * sin_u2 + cos_u1 * cos_u2 * cos_l
        sigma = np.arctan2(sin_sigma, cos_sigma)
        sin_alpha = cos_u1 * cos_u2 * sin_l / sin_sigma
        cos2_alpha = 1.0 - sin_alpha**2
        cos_2sigmam = cos_sigma - (2.0 * sin_u1 * sin_u2) / cos2_alpha
        c = (WGS_84_F / 16.0) * cos2_alpha * (4.0 + WGS_84_F * (4.0 - 3.0 * cos2_alpha))
        lambd_new = big_l + (1.0 - c) * WGS_84_F * sin_alpha * (
            sigma
            + c
            * sin_sigma
            * (cos_2sigmam + c * cos_sigma * (-1.0 + 2.0 * cos_2sigmam**2))
        )
        return lambd_new, (sin_sigma, cos_sigma, sigma, cos2_alpha, cos_2sigmam)

    lambd = big_l
    num_iters = 0
    while True:
        lambd_new, state = _iterate(lambd)
        diff = np.abs(lambd_new - lambd)
        lambd = lambd_new
        num_iters += 1
        if not np.any(diff > tol):
            break
        if num_iters > max_iters:
            raise Warning(
                f"Exceeded {max_iters} iterations without lambda changing by "
                f"less than {tol:.1e}"
            )
    sin_sigma, cos_sigma, sigma, cos2_alpha, cos_2sigmam = state

    u_sq = cos2_alpha * (WGS_84_A**2 - WGS_84_B**2) / WGS_84_B**2
    big_a = 1.0 + (u_sq / 16384.0) * (
        4096.0 + u_sq * (-768.0 + u_sq * (320.0 - 175.0 * u_sq))
    )
    big_b = (u_sq / 1024.0) * (256.0 + u_sq * (-128.0 + u_sq * (74.0 - 47.0 * u_sq)))
    delta_sigma = (
        big_b
        * sin_sigma
        * (
            cos_2sigmam
            + 0.25
            * big_b
            * (
                cos_sigma * (-1.0 + 2.0 * cos_2sigmam**2)
                - (big_b / 6.0)
                * cos_2sigmam
                * (-3.0 + 4.0 * sin_sigma**2)
                * (-3.0 + 4.0 * cos_2sigmam**2)
            )
        )
    )
    s = WGS_84_B * big_a * (sigma - delta_sigma)
    sin_l, cos_l = np.sin(lambd), np.cos(lambd)
    alpha1 = np.arctan2(cos_u2 * sin_l, cos_u1 * sin_u2 - sin_u1 * cos_u2 * cos_l)
    alpha2 = np.arctan2(cos_u1 * sin_l, -sin_u1 * cos_u2 + cos_u1 * sin_u2 * cos_l)
    return s, alpha1 * (180.0 / math.pi), alpha2 * (180.0 / math.pi)


def vincenty_point_along_geodesic(
    latlon1, alpha1, s, tol: float = 1e-6, max_iters: int = 10
):
    """Destination along a geodesic (Vincenty's direct problem).

    Start (lat, lon) in degrees as a tuple or a (2, ...) array, forward
    azimuth in degrees, distance in meters. Returns ((lat2, lon2) in the
    container kind of ``latlon1``, the azimuth at the destination in
    radians, as the reference returns it). Iterates until no sigma moves
    by more than ``tol``; raises ``Warning`` after ``max_iters``.
    """
    is_tuple = isinstance(latlon1, tuple)
    lat1 = latlon1[0] * (math.pi / 180.0)
    lon1 = latlon1[1] * (math.pi / 180.0)
    alpha1 = alpha1 * (math.pi / 180.0)

    u1 = np.arctan((1.0 - WGS_84_F) * np.tan(lat1))
    sin_u1, cos_u1 = np.sin(u1), np.cos(u1)
    cos_a1 = np.cos(alpha1)
    sigma1 = np.arctan2(np.tan(u1), cos_a1)
    sin_alpha = cos_u1 * np.sin(alpha1)
    u_sq = (1.0 - sin_alpha**2) * (WGS_84_A**2 - WGS_84_B**2) / WGS_84_B**2
    big_a = 1.0 + (u_sq / 16384.0) * (
        4096.0 + u_sq * (-768.0 + u_sq * (320.0 - 175.0 * u_sq))
    )
    big_b = (u_sq / 1024.0) * (256.0 + u_sq * (-128.0 + u_sq * (74.0 - 47.0 * u_sq)))

    sigma = s / (WGS_84_B * big_a)

    def _iterate(sigma):
        cos_2sigmam = np.cos(2.0 * sigma1 + sigma)
        delta_sigma = (
            big_b
            * np.sin(sigma)
            * (
                cos_2sigmam
                + 0.25
                * big_b
                * (
                    np.cos(sigma) * (-1.0 + 2.0 * cos_2sigmam**2)
                    - (big_b / 6.0)
                    * cos_2sigmam
                    * (-3.0 + 4.0 * np.sin(sigma) ** 2)
                    * (-3.0 + 4.0 * cos_2sigmam**2)
                )
            )
        )
        return s / (WGS_84_B * big_a) + delta_sigma, cos_2sigmam

    num_iters = 0
    while True:
        sigma_new, cos_2sigmam = _iterate(sigma)
        diff = np.abs(sigma_new - sigma)
        sigma = sigma_new
        num_iters += 1
        if not np.any(diff > tol):
            break
        if num_iters > max_iters:
            raise Warning(
                f"Exceeded {max_iters} iterations without sigma changing by "
                f"less than {tol:.1e}"
            )

    sin_sigma, cos_sigma = np.sin(sigma), np.cos(sigma)
    lat2 = np.arctan2(
        sin_u1 * cos_sigma + cos_u1 * sin_sigma * cos_a1,
        (1.0 - WGS_84_F)
        * np.sqrt(
            sin_alpha**2 + (sin_u1 * sin_sigma - cos_u1 * cos_sigma * cos_a1) ** 2
        ),
    )
    lambd = np.arctan2(
        sin_sigma * np.sin(alpha1), cos_u1 * cos_sigma - sin_u1 * sin_sigma * cos_a1
    )
    c = (
        (WGS_84_F / 16.0)
        * (1.0 - sin_alpha**2)
        * (4.0 + WGS_84_F * (4.0 - 3.0 * (1.0 - sin_alpha**2)))
    )
    big_l = lambd - (1.0 - c) * WGS_84_F * sin_alpha * (
        sigma
        + c * sin_sigma * (cos_2sigmam + c * cos_sigma * (-1.0 + 2.0 * cos_2sigmam**2))
    )
    lon2 = big_l + lon1
    alpha2 = np.arctan2(sin_alpha, -sin_u1 * sin_sigma + cos_u1 * cos_sigma * cos_a1)
    lat2 = lat2 * (180.0 / math.pi)
    lon2 = lon2 * (180.0 / math.pi)
    if is_tuple:
        return (lat2, lon2), alpha2
    return np.stack([lat2, lon2]), alpha2
