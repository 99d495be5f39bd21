"""WGS-84 geometry of the reference: rays from a granule's viewing geometry,
their filter and normalization, the scene's horizontal preprocessor, and
the L1C extraction grid's points.

Geodesy runs in float64 on whatever device the tensors live on; the
per-point preprocessor in float32, as a card computes a render."""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

A = 6378137.0
B = 6356752.314245
E = (A * A - B * B) / (A * A)
E2 = (A * A - B * B) / (B * B)
DEG = math.pi / 180.0


def to_cartesian(lat, lon, alt):
    """Geodetic (deg, deg, m) -> ECEF (x, y, z) m."""
    lat = lat * DEG
    lon = lon * DEG
    s = torch.sin(lat)
    n = A / torch.sqrt(1.0 - E * s * s)
    c = torch.cos(lat)
    return (n + alt) * c * torch.cos(lon), (n + alt) * c * torch.sin(lon), (n * (1.0 - E) + alt) * s


def to_geodetic(x, y, z):
    """ECEF -> geodetic by Bowring's first-order formula, in the inputs'
    dtype; the altitude as ``x / (cos lat cos lon) - N``."""
    lon = torch.atan2(y, x)
    d = torch.sqrt(x * x + y * y)
    u = torch.atan2(z / d, torch.zeros_like(x) + (A / B))
    su, cu = torch.sin(u), torch.cos(u)
    lat = torch.atan2(z + (E2 * B) * su**3, d - (E * A) * cu**3)
    n = A / torch.sqrt(1.0 - E * torch.sin(lat) ** 2)
    alt = x / (torch.cos(lat) * torch.cos(lon)) - n
    return lat * (180.0 / math.pi), lon * (180.0 / math.pi), alt


def _view_dirs(theta, phi, lat, lon):
    """Unit view directions in ECEF, pointing from the top of the atmosphere
    down to the pixel: the zenith/azimuth vector rotated onto the pixel's
    local frame."""
    t, p = -theta * DEG, -phi * DEG
    dx, dy, dz = torch.sin(p) * torch.sin(t), -torch.cos(p) * torch.sin(t), torch.cos(t)
    t2, p2 = -(90.0 - lat) * DEG, -(90.0 - lon) * DEG
    st, ct, sp, cp = torch.sin(t2), torch.cos(t2), torch.sin(p2), torch.cos(p2)
    vx, vy, vz = -dx, -dy, dz
    ox = cp * vx + (-sp * ct) * vy + (sp * st) * vz
    oy = sp * vx + (cp * ct) * vy + (-cp * st) * vz
    oz = st * vy + ct * vz
    return -ox, -oy, -oz


def build_rays(lat, lon, alt, theta, phi, origin_height: float, tol: float = 10.0,
               max_iters: int = 20, dtype=torch.float64):
    """Rays of flat float32 pixel-view arrays: (N, 3) float32 origins at
    ``origin_height`` above the ellipsoid, (N, 3) float32 directions and
    (N,) float32 lengths, the geodesy in ``dtype``. Each ray's length is
    refined on its own until its origin lies within ``tol`` metres of the
    height."""
    f64 = dtype
    lat, lon, alt, theta, phi = (a.to(f64) for a in (lat, lon, alt, theta, phi))
    x, y, z = to_cartesian(lat, lon, alt)
    x, y, z = (c.to(torch.float32).to(f64) for c in (x, y, z))
    cx, cy, cz = _view_dirs(theta, phi, lat, lon)
    length = (origin_height - alt) / torch.cos(theta * DEG)
    for _ in range(max_iters + 1):
        _, _, h = to_geodetic(x - length * cx, y - length * cy, z - length * cz)
        moving = torch.abs(origin_height - h) > tol
        if not bool(moving.any()):
            break
        length = torch.where(moving, length * (origin_height / h), length)
    length = length.to(torch.float32).to(f64)
    origin = torch.stack([x - cx * length, y - cy * length, z - cz * length], -1)
    direction = torch.stack([cx, cy, cz], -1)
    return origin.to(torch.float32), direction.to(torch.float32), length.to(torch.float32)


def l1c_points(lat_pv: np.ndarray, lon_pv: np.ndarray, alt_pv: np.ndarray, shape,
               alt_step: float, top: float, dtype=np.float64) -> np.ndarray:
    """The pseudo-L1C grid of a granule without an L1C product: each
    pixel's mean geolocation over its views (NaN -> 0), under an altitude
    ladder from 0 to ``top`` by ``alt_step``; (H*W*levels, 3) float64 ECEF,
    pixel-major, altitude fastest."""
    h, w = shape
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        lat = np.nan_to_num(np.nanmean(lat_pv.reshape(h, w, -1), axis=-1))
        lon = np.nan_to_num(np.nanmean(lon_pv.reshape(h, w, -1), axis=-1))
    ladder = np.arange(0.0, top + alt_step / 2, alt_step)
    la = np.repeat(lat[:, :, None], ladder.size, axis=2).astype(dtype)
    lo = np.repeat(lon[:, :, None], ladder.size, axis=2).astype(dtype)
    al = np.broadcast_to(ladder[None, None], la.shape).astype(dtype)
    x, y, z = to_cartesian(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (la, lo, al)))
    return torch.stack([x, y, z], -1).reshape(-1, 3).numpy().astype(np.float64)
