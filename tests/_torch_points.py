"""ECEF points for the tests of the extraction's normalisation
(``atmonr_tpu_torch/extract/runner.py::normalize``), which must equal the
host's ``((xyz - offset) / scale).astype(np.float32)`` bit for bit.

Most float64 quotients lie far from a float32 rounding boundary, so a
product with the reciprocal of the scale, an ulp off the true quotient in
float64, rounds to the same float32 nearly always. ``midpoint_points`` puts
the normalized coordinates at midpoints between neighbouring float32
values, where that last float64 bit decides the rounding."""

from __future__ import annotations

import numpy as np


def ecef_points(n: int, seed: int) -> np.ndarray:
    """(n, 3) float64 ECEF points in meters: uniform latitudes within 80
    degrees, any longitude, from 500 m below to 20 km above a 6,371 km
    sphere."""
    rng = np.random.default_rng(seed)
    lat, lon = rng.uniform(-1.4, 1.4, n), rng.uniform(-np.pi, np.pi, n)
    r = 6.371e6 + rng.uniform(-500.0, 20_000.0, n)
    return np.stack([r * np.cos(lat) * np.cos(lon), r * np.cos(lat) * np.sin(lon),
                     r * np.sin(lat)], axis=1)


def midpoint_points(n: int, seed: int, offset, scale: float, reach: float = 0.99) -> np.ndarray:
    """(n, 3) float64 ECEF points whose normalized coordinates lie within a
    few float64 ulps of the midpoint between a float32 in (-reach, reach)
    and the next one up."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(-reach, reach, (n, 3)).astype(np.float32)
    mid = (f.astype(np.float64) + np.nextafter(f, np.float32(np.inf)).astype(np.float64)) / 2
    return mid * scale + np.asarray(offset, np.float64)[None]
