"""Synthetic HARP2 granule generation for offline testing and benchmarking.

A numpy copy of ``make_synthetic_granule`` from the JAX package's
``data/synthetic.py``: a swath of geolocated pixels observed from several
view angles across the four HARP2 bands, with radiances rendered from a
simple analytic cloud so that training has real structure to fit. The same
seed gives the same granule as the JAX package.
"""

from __future__ import annotations

import numpy as np

from atmonr_tpu_torch.data.granule import GranuleArrays

# HARP2 band wavelengths (nm): infrared, red, green, blue
BAND_WAVELENGTHS = {0: 867.0, 1: 669.0, 2: 550.0, 3: 441.0}


def make_synthetic_granule(
    height: int = 24,
    width: int = 16,
    views_per_band: int = 2,
    lat0: float = 20.0,
    lon0: float = -40.0,
    pixel_deg: float = 0.02,
    max_view_angle: float = 40.0,
    nan_fraction: float = 0.02,
    seed: int = 0,
    n_blobs: int = 1,
) -> GranuleArrays:
    """Build an in-memory fake HARP2 L1B granule.

    The swath is a regular lat/lon grid (latitude decreasing along-track, as
    the real product is ordered); each band contributes ``views_per_band``
    views at distinct zenith angles. Radiances are a smooth Gaussian "cloud"
    plus a band-dependent surface term, scaled per-view so multi-angle
    structure exists.

    ``n_blobs > 1`` builds a hard scene instead: a multi-scale field of
    random Gaussian cells (broken-cloud texture down to a few pixels wide),
    so model capacity actually discriminates — the default single bump is
    fit perfectly by tiny models and cannot rank encoder sizes.
    """
    rng = np.random.default_rng(seed)
    n_views = 4 * views_per_band

    # per-view angle table: spread views in [-max, max], grouped by band
    view_angles = np.linspace(-max_view_angle, max_view_angle, n_views)
    bands = np.tile(np.arange(4), views_per_band)
    rng.shuffle(bands)
    wavelengths = np.array([BAND_WAVELENGTHS[b] for b in bands])

    # the L1B product stores south-first; the loader's north-up flip then
    # yields latitude decreasing with row index (the voxelgrid assumption)
    lat_1d = lat0 + np.arange(height) * pixel_deg
    lon_1d = lon0 + np.arange(width) * pixel_deg
    lat2, lon2 = np.meshgrid(lat_1d, lon_1d, indexing="ij")

    lat = np.broadcast_to(lat2, (n_views, height, width)).copy()
    lon = np.broadcast_to(lon2, (n_views, height, width)).copy()
    # small view-dependent parallax jitter
    lat += rng.normal(scale=1e-4, size=lat.shape)
    lon += rng.normal(scale=1e-4, size=lon.shape)
    alt = np.abs(rng.normal(scale=30.0, size=lat.shape))

    thetav = np.abs(view_angles)[:, None, None] * np.ones((1, height, width))
    thetav += rng.normal(scale=0.05, size=thetav.shape)
    phiv = np.where(view_angles < 0, -90.0, 90.0)[:, None, None] * np.ones(
        (1, height, width)
    )
    phiv += rng.normal(scale=0.5, size=phiv.shape)

    # radiances: gaussian cloud bump + surface albedo, per-band scaling
    cy, cx = lat0 + height * pixel_deg / 2, lon0 + width * pixel_deg / 2
    if n_blobs <= 1:
        r2 = ((lat - cy) / (height * pixel_deg / 3)) ** 2 + (
            (lon - cx) / (width * pixel_deg / 3)
        ) ** 2
        cloud = np.exp(-r2)
    else:
        # multi-scale broken-cloud field: cell widths span the swath scale
        # down to ~2 pixels, log-uniformly
        cloud = np.zeros_like(lat)
        lat_span, lon_span = height * pixel_deg, width * pixel_deg
        for _ in range(n_blobs):
            by = lat0 + rng.uniform(0.05, 0.95) * lat_span
            bx = lon0 + rng.uniform(0.05, 0.95) * lon_span
            sy = np.exp(rng.uniform(np.log(2 * pixel_deg), np.log(lat_span / 4)))
            sx = np.exp(rng.uniform(np.log(2 * pixel_deg), np.log(lon_span / 4)))
            amp = rng.uniform(0.3, 1.0)
            cloud += amp * np.exp(
                -(((lat - by) / sy) ** 2 + ((lon - bx) / sx) ** 2)
            )
        cloud = np.clip(cloud, 0.0, 1.5) / 1.5
    band_scale = np.array([0.8, 1.0, 0.9, 0.7])[bands][:, None, None]
    view_scale = 1.0 - 0.3 * (np.abs(view_angles) / max_view_angle)[:, None, None]
    i = (0.2 + 0.8 * cloud) * band_scale * view_scale * 100.0
    i += rng.normal(scale=0.5, size=i.shape)

    # sprinkle invalid pixels
    nan_mask = rng.uniform(size=i.shape) < nan_fraction
    i[nan_mask] = np.nan

    return GranuleArrays(
        level="L1B",
        product_name="PACE_HARP2.SYNTHETIC.L1B.nc",
        lat=lat,
        lon=lon,
        alt=alt,
        thetav=thetav,
        phiv=phiv,
        i=i,
        view_angles=view_angles,
        wavelengths=wavelengths,
    )

