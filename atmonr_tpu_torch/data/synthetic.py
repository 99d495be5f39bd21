"""Synthetic HARP2 granule generation for offline testing and benchmarking.

The port's copy of the JAX package's ``data/synthetic.py``:
``make_synthetic_granule`` builds a swath of geolocated pixels observed
from several view angles across the four HARP2 bands, with radiances
rendered from a simple analytic cloud so that training has real structure
to fit; the writers put granules, an L1C grid, an EarthCARE track and a
DEM on disk in the products' netCDF-4 (HDF5) layouts, so the file-reading
paths run without NASA Earthdata access. ``real_schema_granule`` gives the
granule of ``write_granule_l1b_real_schema`` without a file, as
``read_granule`` returns it from the written one: the route where h5py is
not installed. The same seed gives the same granule, and the same files, as
the JAX package. h5py is imported only inside the writers.
"""

from __future__ import annotations

from pathlib import Path

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



def write_granule_l1b(granule: GranuleArrays, path: str | Path) -> None:
    """Write a GranuleArrays to disk in HARP2 L1B netCDF-4 (HDF5) layout."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["processing_level"] = granule.level
        f.attrs["product_name"] = granule.product_name
        geo = f.create_group("geolocation_data")
        obs = f.create_group("observation_data")
        svb = f.create_group("sensor_views_bands")
        fill = -32767.0

        def _w(group, name, arr):
            arr = np.asarray(arr, np.float64).copy()
            arr[np.isnan(arr)] = fill
            ds = group.create_dataset(name, data=arr)
            ds.attrs["_FillValue"] = fill

        _w(geo, "latitude", granule.lat)
        _w(geo, "longitude", granule.lon)
        _w(geo, "surface_altitude", granule.alt)
        _w(geo, "sensor_zenith_angle", granule.thetav)
        _w(geo, "sensor_azimuth_angle", granule.phiv)
        _w(obs, "i", granule.i)
        _w(svb, "sensor_view_angle", granule.view_angles)
        _w(svb, "intensity_wavelength", granule.wavelengths)


def write_granule_l1c(
    path: str | Path,
    height: int = 10,
    width: int = 6,
    lat0: float = 20.0,
    lon0: float = -40.0,
    pixel_deg: float = 0.04,
) -> None:
    """Write a minimal HARP2 L1C-layout netCDF-4 file: the 2-D
    ``geolocation_data/{latitude,longitude,height}`` grid the L1C extract
    mode reads."""
    import h5py

    lat_1d = lat0 + np.arange(height) * pixel_deg
    lon_1d = lon0 + np.arange(width) * pixel_deg
    lat2, lon2 = np.meshgrid(lat_1d, lon_1d, indexing="ij")
    hgt = 50.0 * (1 + np.sin(lat2) * np.cos(lon2))

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fill = -32767.0
    with h5py.File(path, "w") as f:
        f.attrs["processing_level"] = "L1C"
        geo = f.create_group("geolocation_data")
        for name, arr in [
            ("latitude", lat2),
            ("longitude", lon2),
            ("height", hgt),
        ]:
            ds = geo.create_dataset(name, data=np.asarray(arr, np.float64))
            ds.attrs["_FillValue"] = fill


def write_synthetic_earthcare(
    path: str | Path,
    n_along: int = 40,
    n_height: int = 20,
    lat0: float = 20.0,
    lon0: float = -40.0,
) -> None:
    """Write a minimal EarthCARE ATL_EBD_2A-layout HDF5 track for testing
    the earthcare extraction mode offline."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lat = lat0 - np.linspace(0, 0.4, n_along)
    lon = lon0 + np.linspace(0, 0.2, n_along)
    height = np.broadcast_to(
        np.linspace(18000, 500, n_height)[None], (n_along, n_height)
    ).copy()
    with h5py.File(path, "w") as f:
        f.create_dataset(
            "HeaderData/FixedProductHeader/File_Type", data=b"ATL_EBD_2A"
        )
        sd = f.create_group("ScienceData")
        for name, data in [("latitude", lat), ("longitude", lon), ("height", height)]:
            ds = sd.create_dataset(name, data=data)
            ds.attrs["units"] = b"deg" if name != "height" else b"m"
            ds.attrs["long_name"] = name.encode()
            ds.attrs["comment"] = b"synthetic test track"
            ds.attrs["_FillValue"] = np.array([-9999.0])


def write_synthetic_dem(
    path: str | Path,
    height: np.ndarray,
    water_surface_height: np.ndarray | None = None,
    upper_lat: float = 25.0,
    left_lon: float = -45.0,
    lat_res: float = 0.25,
    lon_res: float = 0.25,
) -> None:
    """Write a DEM in the ETOPO1_ocssw.nc layout the voxelgrid extraction
    reads (``extract.datasets.interp_dem_height``): root attrs
    ``upper_lat``/``left_lon``/``geospatial_lat_resolution``/
    ``geospatial_lon_resolution`` plus the 2-D ``height`` and
    ``water_surface_height`` datasets (rows run north to south from
    ``upper_lat``)."""
    import h5py

    height = np.asarray(height, np.float64)
    if water_surface_height is None:
        water_surface_height = np.full_like(height, -1.0e4)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["upper_lat"] = float(upper_lat)
        f.attrs["left_lon"] = float(left_lon)
        f.attrs["geospatial_lat_resolution"] = float(lat_res)
        f.attrs["geospatial_lon_resolution"] = float(lon_res)
        f.create_dataset("height", data=height)
        f.create_dataset(
            "water_surface_height",
            data=np.asarray(water_surface_height, np.float64),
        )


# The real-schema granule: its fill value, and each variable's group, name,
# field of GranuleArrays, units, long name and valid range
REAL_SCHEMA_FILL = np.float32(-999.0)
REAL_SCHEMA_VARS = (
    ("geolocation_data", "latitude", "lat", "degrees_north", "Latitude", -90, 90),
    ("geolocation_data", "longitude", "lon", "degrees_east", "Longitude", -180, 180),
    ("geolocation_data", "surface_altitude", "alt", "m", "Terrain height", -1000, 10000),
    ("geolocation_data", "sensor_zenith_angle", "thetav", "degrees", "Sensor zenith", 0, 90),
    ("geolocation_data", "sensor_azimuth_angle", "phiv", "degrees", "Sensor azimuth",
     -180, 360),
    ("observation_data", "i", "i", "W.m-2.sr-1.um-1", "I Stokes vector component", 0, 800),
)
REAL_SCHEMA_NAME = "PACE_HARP2.20240101T000000.L1B.V3.SYNTHETIC.nc"


def _draw_real_schema(
    height: int, width: int, seed: int, n_blobs: int, blob_max: float, noise: float
) -> dict[str, np.ndarray]:
    """The real-schema granule's arrays before they are written: the per-view
    ``view_angles`` and ``wavelengths`` (float64), and the fields ``lat``,
    ``lon``, ``alt``, ``thetav``, ``phiv`` (float64) and ``i`` (float32,
    ``REAL_SCHEMA_FILL`` at invalid pixels), each (views, height, width).
    One ``default_rng(seed)`` draws, in this order: the band shuffle, the
    two geolocation jitters, the altitudes, five uniforms per blob, the
    radiance noise."""
    rng = np.random.default_rng(seed)

    # real HARP2 view complement, interleaved along the view axis the way
    # the instrument tables are (band of each view, 90 entries)
    bands = np.concatenate(
        [np.full(60, 1), np.full(10, 0), np.full(10, 2), np.full(10, 3)]
    )
    rng.shuffle(bands)
    n_views = bands.size
    spread = {0: 55.0, 1: 57.0, 2: 55.0, 3: 55.0}
    view_angles = np.empty(n_views)
    for b in range(4):
        m = bands == b
        view_angles[m] = np.linspace(-spread[b], spread[b], m.sum())
    wavelengths = np.array([BAND_WAVELENGTHS[b] for b in bands])

    lat_1d = 18.0 + np.arange(height) * 0.02
    lon_1d = -42.0 + np.arange(width) * 0.02
    lat2, lon2 = np.meshgrid(lat_1d, lon_1d, indexing="ij")
    lat = lat2 + rng.normal(scale=1e-4, size=(n_views, height, width))
    lon = lon2 + rng.normal(scale=1e-4, size=(n_views, height, width))
    alt = np.abs(rng.normal(scale=30.0, size=lat.shape))
    thetav = np.abs(view_angles)[:, None, None] * np.ones((1, height, width))
    phiv = np.where(view_angles < 0, 260.0, 80.0)[:, None, None] * np.ones(
        (1, height, width)
    )

    # radiance: smooth cloud + per-band surface term + sensor noise.
    # n_blobs > 1 builds the multi-scale broken-cloud field instead, so
    # quality comparisons at real-granule scale have structure that
    # discriminates capacity and sampling strategy. ``blob_max`` caps the
    # cell width (in [-1,1] swath units) and ``noise`` sets the sensor-noise
    # sigma: the noise floor bounds the achievable PSNR (~20 log10(max_i /
    # noise)), so a quality A/B must keep it low enough that structure, not
    # noise, limits the score.
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, height), np.linspace(-1, 1, width), indexing="ij"
    )
    if n_blobs <= 1:
        cloud = np.exp(-((yy**2 + xx**2) / 0.18))
    else:
        cloud = np.zeros((height, width))
        min_s = 2.0 * 2.0 / max(height, width)  # ~2-pixel cells at the floor
        for _ in range(n_blobs):
            by, bx = rng.uniform(-0.9, 0.9, 2)
            sy = np.exp(rng.uniform(np.log(min_s), np.log(blob_max)))
            sx = np.exp(rng.uniform(np.log(min_s), np.log(blob_max)))
            amp = rng.uniform(0.3, 1.0)
            cloud += amp * np.exp(
                -(((yy - by) / sy) ** 2 + ((xx - bx) / sx) ** 2)
            )
        cloud = np.clip(cloud, 0.0, 1.5) / 1.5
    i_rad = (
        0.3
        + 0.1 * bands[:, None, None]
        + cloud[None] * (1.2 - 0.05 * bands[:, None, None])
        + rng.normal(scale=noise, size=(n_views, height, width))
    ).astype(np.float32)

    # invalid pixels: swath-edge fill, plus striped red views (every other
    # along-track row invalid, the artifact the rgb selection must dodge)
    i_rad[:, :, 0] = REAL_SCHEMA_FILL
    striped_views = np.flatnonzero(bands == 1)[:3]
    i_rad[striped_views, ::2, :] = REAL_SCHEMA_FILL
    return {"view_angles": view_angles, "wavelengths": wavelengths, "lat": lat, "lon": lon,
            "alt": alt, "thetav": thetav, "phiv": phiv, "i": i_rad}


def _as_read(arr: np.ndarray, vmin: float | None = None, vmax: float | None = None
             ) -> np.ndarray:
    """``arr`` as ``read_granule`` returns it after a float32 write: the
    float32 value in float64, NaN at the fill value and outside
    [``vmin``, ``vmax``]."""
    f32 = np.asarray(arr, np.float32)
    mask = f32 == REAL_SCHEMA_FILL
    if vmin is not None:
        mask |= f32 < np.float32(vmin)
    if vmax is not None:
        mask |= f32 > np.float32(vmax)
    out = f32.astype(np.float64)
    out[mask] = np.nan
    return out


def real_schema_granule(
    height: int = 16,
    width: int = 10,
    seed: int = 0,
    n_blobs: int = 1,
    blob_max: float = 0.5,
    noise: float = 0.01,
    product_name: str = REAL_SCHEMA_NAME,
) -> GranuleArrays:
    """The granule ``write_granule_l1b_real_schema`` writes, as
    ``read_granule`` returns it from that file (named ``product_name``),
    with no file: every field the written float32 value in float64, NaN at
    the fill value and outside the valid range. The same arguments draw the
    same arrays as the writer, bit for bit."""
    a = _draw_real_schema(height, width, seed, n_blobs, blob_max, noise)
    fields = {field: _as_read(a[field], vmin, vmax)
              for _, _, field, _, _, vmin, vmax in REAL_SCHEMA_VARS}
    return GranuleArrays(
        level="L1B",
        product_name=product_name,
        view_angles=_as_read(a["view_angles"]),
        wavelengths=_as_read(a["wavelengths"]).flatten(),
        **fields,
    )


def write_granule_l1b_real_schema(
    path: str | Path,
    height: int = 16,
    width: int = 10,
    seed: int = 0,
    n_blobs: int = 1,
    blob_max: float = 0.5,
    noise: float = 0.01,
) -> None:
    """Write a synthetic granule in the REAL PACE_HARP2 L1B file schema.

    Unlike ``write_granule_l1b`` (minimal layout for fast unit tests), this
    mirrors the OB.DAAC product structure: the real view complement (90
    views: 60 red, 10 each IR/green/blue, interleaved), named netCDF-4
    dimension scales (``number_of_views``/``bins_along_track``/
    ``pixels_across_track``), float32 variables carrying ``_FillValue``
    -999.0 + ``valid_min``/``valid_max`` + ``units``/``long_name`` attrs,
    fill-coded invalid pixels, striped red views (reduced valid-pixel
    count), and the root attribute set (instrument/platform/
    processing_level/product_name). ``real_schema_granule`` gives what
    ``read_granule`` reads back, without the file.
    """
    import h5py

    a = _draw_real_schema(height, width, seed, n_blobs, blob_max, noise)
    n_views = a["view_angles"].size

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["title"] = "HARP2 Level-1B Data"
        f.attrs["instrument"] = "HARP2"
        f.attrs["platform"] = "PACE"
        f.attrs["processing_level"] = "L1B"
        f.attrs["product_name"] = path.name
        f.attrs["date_created"] = "2026-01-01T00:00:00Z"

        def make_dim(name, n):
            d = f.create_dataset(name, data=np.arange(n, dtype=np.int32))
            d.make_scale(name)
            return d

        dims = [
            make_dim("number_of_views", n_views),
            make_dim("bins_along_track", height),
            make_dim("pixels_across_track", width),
        ]

        groups = {}
        for group, name, field, units, long_name, vmin, vmax in REAL_SCHEMA_VARS:
            if group not in groups:
                groups[group] = f.create_group(group)
            arr = np.asarray(a[field], np.float32)
            ds = groups[group].create_dataset(name, data=arr)
            ds.attrs["_FillValue"] = REAL_SCHEMA_FILL
            ds.attrs["valid_min"] = np.float32(vmin)
            ds.attrs["valid_max"] = np.float32(vmax)
            ds.attrs["units"] = units
            ds.attrs["long_name"] = long_name
            for axis in range(arr.ndim):
                ds.dims[axis].attach_scale(dims[axis + (3 - arr.ndim)])
        svb = f.create_group("sensor_views_bands")
        for name, field, units in (("sensor_view_angle", "view_angles", "degrees"),
                                   ("intensity_wavelength", "wavelengths", "nm")):
            ds = svb.create_dataset(name, data=a[field].astype(np.float32))
            ds.attrs["_FillValue"] = REAL_SCHEMA_FILL
            ds.attrs["units"] = units
            ds.dims[0].attach_scale(dims[0])
