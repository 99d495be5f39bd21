"""HARP2 granule containers and netCDF-4 (HDF5) I/O.

A numpy copy of the JAX package's ``data/granule.py``. netCDF-4 files are
HDF5 containers, read with h5py (replicating netCDF4's automatic masking and
scale/offset handling). h5py is imported only when a file is read, so the
package imports where it is missing. All host-side processing is numpy;
device tensors are produced downstream by ``atmonr_tpu_torch.data.harp2``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class GranuleArrays:
    """In-memory representation of a HARP2 L1B/L1C granule.

    Field layouts follow the on-disk product: per-view geolocation and
    radiance arrays plus the per-view angle/wavelength tables. ``level`` is
    "L1B" (fields are (views, along, across)) or "L1C" ((along, across,
    views[, stokes])).
    """

    level: str
    product_name: str
    lat: np.ndarray
    lon: np.ndarray
    alt: np.ndarray  # surface_altitude (L1B) / height (L1C)
    thetav: np.ndarray  # sensor_zenith_angle
    phiv: np.ndarray  # sensor_azimuth_angle
    i: np.ndarray  # observation_data/i radiances
    view_angles: np.ndarray  # sensor_views_bands/sensor_view_angle
    wavelengths: np.ndarray  # sensor_views_bands/intensity_wavelength (flat)


def _read_var(f, path: str) -> np.ndarray:
    """Read an HDF5 variable with netCDF4-equivalent semantics:

    apply scale_factor/add_offset, convert to float, fill _FillValue (and
    values outside valid_min/valid_max) with NaN.
    """
    ds = f[path]
    arr = np.asarray(ds[...])
    attrs = dict(ds.attrs)
    fill = attrs.get("_FillValue")
    mask = np.zeros(arr.shape, dtype=bool)
    if fill is not None:
        mask |= arr == np.asarray(fill).ravel()[0]
    # valid range applies to the raw (packed) values, netCDF4 semantics
    vmin = attrs.get("valid_min")
    vmax = attrs.get("valid_max")
    if vmin is not None:
        mask |= arr < np.asarray(vmin).ravel()[0]
    if vmax is not None:
        mask |= arr > np.asarray(vmax).ravel()[0]
    arr = arr.astype(np.float64)
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    if scale is not None:
        arr = arr * np.asarray(scale).ravel()[0]
    if offset is not None:
        arr = arr + np.asarray(offset).ravel()[0]
    arr[mask] = np.nan
    return arr


def read_granule(path: str | Path) -> GranuleArrays:
    """Read a HARP2 L1B or L1C netCDF-4 product into numpy arrays."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is required to read HARP2 granules; use the 'synthetic' "
            "scene name where it is not installed"
        ) from e
    path = Path(path)
    with h5py.File(path, "r") as f:
        level_attr = f.attrs.get("processing_level", b"L1B")
        level = (
            level_attr.decode()
            if isinstance(level_attr, bytes)
            else str(np.asarray(level_attr).ravel()[0])
        )
        if isinstance(level, bytes):
            level = level.decode()
        product_attr = f.attrs.get("product_name", path.name)
        product_name = (
            product_attr.decode()
            if isinstance(product_attr, bytes)
            else str(product_attr)
        )
        alt_field = (
            "geolocation_data/surface_altitude"
            if level == "L1B"
            else "geolocation_data/height"
        )
        return GranuleArrays(
            level=level,
            product_name=product_name,
            lat=_read_var(f, "geolocation_data/latitude"),
            lon=_read_var(f, "geolocation_data/longitude"),
            alt=_read_var(f, alt_field),
            thetav=_read_var(f, "geolocation_data/sensor_zenith_angle"),
            phiv=_read_var(f, "geolocation_data/sensor_azimuth_angle"),
            i=_read_var(f, "observation_data/i"),
            view_angles=_read_var(f, "sensor_views_bands/sensor_view_angle"),
            wavelengths=_read_var(
                f, "sensor_views_bands/intensity_wavelength"
            ).flatten(),
        )


def get_indexes(
    granule: GranuleArrays,
    max_abs_view_angle: float,
    bands_to_keep: list | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """View filtering + IRGB band indexing.

    Returns (view_idx, irgb_idx): the kept views sorted by decreasing
    wavelength, and each view's band index (0: infrared, 1: red, 2: green,
    3: blue). Parity: reference datasets/harp2.py:461-501.
    """
    if bands_to_keep is None:
        bands_to_keep = [0, 1, 2, 3]
    if granule.level not in ("L1B", "L1C"):
        raise NotImplementedError(
            f"Not implemented for level {granule.level} data!"
        )
    angles = granule.view_angles
    angles_filtered = np.where(np.abs(angles) <= max_abs_view_angle)[0]
    wavelengths = granule.wavelengths
    view_order = np.argsort(-wavelengths, stable=True)
    view_idx = view_order[np.isin(view_order, angles_filtered)]
    irgb_idx = np.where(
        wavelengths[view_idx, None] == np.unique(wavelengths)[None, ::-1]
    )[1]
    mask = np.isin(irgb_idx, bands_to_keep)
    return view_idx[mask], irgb_idx[mask]


def parse_field(
    arr: np.ndarray, level: str, view_idx: np.ndarray
) -> np.ndarray:
    """Normalize a HARP2 field to (pixels, kept_views) float32:

    1) invalid values are NaN (done at read time), 2) views filtered and in
    IRGB order, 3) North at the top, 4) angle dim last, 5) image dims
    flattened. Parity: reference datasets/harp2.py:82-103.
    """
    assert 2 <= arr.ndim <= 4
    nv = view_idx.shape[0]
    if level == "L1B":
        return (
            arr[view_idx, ::-1]
            .transpose((1, 2, 0))
            .reshape((-1, nv))
            .astype(np.float32)
        )
    if arr.ndim == 4:
        arr = arr[..., 0]
    if arr.ndim == 3:
        return arr[::-1, :, view_idx].reshape((-1, nv)).astype(np.float32)
    return (
        np.tile(arr[::-1, :, None], (1, 1, nv)).reshape((-1, nv)).astype(np.float32)
    )
