"""Extraction grids: the sample points at which a trained model's
extinction field is queried, and how each grid is written out.

The counterpart of the JAX package's ``extract/datasets.py``, over the
port's own ``HARP2Dataset``. Every grid is built on the host in float64
(meter-accurate geodesy from ``atmonr_tpu_torch.geo`` in numpy; the
regional grids' points over their altitude ladder and the global grid's
voxel walk in the host library, ``atmonr_tpu_torch.native``); the
batched query on the card is ``atmonr_tpu_torch.extract.runner``. Four
coordinate modes:

- ``l1c``: the horizontal grid of the matching HARP2 L1C product;
- ``voxelgrid``: a near-uniform geodesic grid marched with Vincenty's
  solves, with surface heights from the ETOPO1 DEM;
- ``globalgrid``: a spherical-Earth voxel grid from a traversal of the
  rays, for large-scale visualization (OpenVDB);
- ``earthcare``: the sample points of an EarthCARE ATL_EBD_2A track.

h5py (the L1C, DEM and EarthCARE readers) is imported only where a file is
read, so the module imports where it is missing.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Callable

import numpy as np

from atmonr_tpu_torch import native
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.extract.voxel_traversal import voxel_traversal_numpy
from atmonr_tpu_torch.extract.writers import (
    earthcare_to_netcdf,
    extract_to_netcdf,
    global_grid_dump,
)
from atmonr_tpu_torch.geo import spherical as sph
from atmonr_tpu_torch.geo import wgs84
from atmonr_tpu_torch.utils import spans

_CHUNK_SIZE = int(3e4)
DEM_PATH = "data/ETOPO1_ocssw.nc"


class HARP2ExtractDataset:
    """Abstract base: sample points ``xyz`` (N, 3) float64 ECEF with their
    ``idx``, the grid's shape ``shp``, and ``dump``."""

    def __init__(self, dataset: HARP2Dataset) -> None:
        if type(self) is HARP2ExtractDataset:
            raise NotImplementedError
        self.dataset = dataset
        self.shp: tuple = (0, 0)
        self.xyz = np.zeros((0, 3), np.float64)
        self.idx = np.zeros((0,), np.int32)

    def __len__(self) -> int:
        return self.xyz.shape[0]

    def dump(self, output_filepath: Path, sigma: np.ndarray) -> None:
        raise NotImplementedError


class _HARP2LocalExtractDataset(HARP2ExtractDataset):
    """Base of the regional grids: the altitude ladder and the netCDF dump."""

    def __init__(
        self,
        dataset: HARP2Dataset,
        alt_step: float,
        min_alt: float | None = None,
        max_alt: float | None = None,
    ) -> None:
        if type(self) is _HARP2LocalExtractDataset:
            raise NotImplementedError
        super().__init__(dataset)
        self.alt_step = alt_step
        self.min_alt = 0.0 if min_alt is None else min_alt
        self.max_alt = dataset.config["ray_origin_height"] if max_alt is None else max_alt
        self.sample_alt = np.arange(self.min_alt, self.max_alt + self.alt_step / 2, self.alt_step)

    def _grid_from_latlon(self, lat2d: np.ndarray, lon2d: np.ndarray) -> None:
        """Expand a horizontal (H, W) lat/lon grid by the altitude ladder:
        the geodesy once a pixel, expanded over the ladder in the host
        library. ``lat`` and ``lon`` are (H, W, na) read-only views of the
        2-D grids."""
        shape = lat2d.shape + self.sample_alt.shape
        with spans.span("extract.grid.points", count=int(np.prod(shape))):
            xyz = native.horizontal_grid_to_cartesian(lat2d, lon2d, self.sample_alt)
        self.lat = np.broadcast_to(lat2d[:, :, None], shape)
        self.lon = np.broadcast_to(lon2d[:, :, None], shape)
        self.xyz = xyz.reshape(-1, 3)
        self.idx = np.arange(self.xyz.shape[0], dtype=np.int32)

    def dump(self, output_filepath: Path, sigma: np.ndarray) -> None:
        extract_to_netcdf(output_filepath, self, sigma)


class HARP2L1CExtractDataset(_HARP2LocalExtractDataset):
    """The horizontal grid of the matching L1C product, with a user-defined
    altitude ladder. A synthetic granule has no L1C product; its grid is the
    per-pixel mean geolocation of the granule's views (a pseudo-L1C)."""

    def __init__(
        self,
        dataset: HARP2Dataset,
        alt_step: float,
        min_alt: float | None = None,
        max_alt: float | None = None,
        data_root: str | Path = "data",
        **_: object,
    ) -> None:
        super().__init__(dataset, alt_step, min_alt, max_alt)

        l1c = self._load_l1c(dataset, Path(data_root))
        if l1c is not None:
            lat2d, lon2d, height = l1c
        else:
            h, w = dataset.img_shp[0], dataset.img_shp[1]
            with warnings.catch_warnings():
                # all-NaN pixels (no valid view) stay NaN, then become 0 below
                warnings.simplefilter("ignore", RuntimeWarning)
                lat2d = np.nanmean(dataset.lat.reshape(h, w, -1), axis=-1)
                lon2d = np.nanmean(dataset.lon.reshape(h, w, -1), axis=-1)
                height = np.nanmean(dataset.alt.reshape(h, w, -1), axis=-1)
        self.height = np.nan_to_num(height)
        lat2d = np.nan_to_num(lat2d)
        lon2d = np.nan_to_num(lon2d)
        self.shp = (lat2d.shape[0], lat2d.shape[1], self.sample_alt.shape[0])
        self._grid_from_latlon(lat2d, lon2d)

    @staticmethod
    def _load_l1c(dataset: HARP2Dataset, data_root: Path):
        """Read the L1C product matching the loaded L1B granule from
        ``<data_root>/HARP2_L1C/``: (lat, lon, height), north up. None for
        a synthetic granule. Earthdata downloads are not ported: a missing
        file raises ``FileNotFoundError``."""
        name = dataset.granule.product_name
        parts = name.split(".")
        if len(parts) < 4 or "SYNTHETIC" in name:
            return None
        sensor, timestamp, _, version = parts[:4]
        path = data_root / "HARP2_L1C" / f"{sensor}.{timestamp}.L1C.{version}.5km.nc"
        if not path.exists():
            raise FileNotFoundError(
                f"L1C product {path} not found; place it there (Earthdata "
                "downloads are not ported)"
            )
        import h5py

        with h5py.File(path, "r") as f:

            def rd(k):
                arr = np.asarray(f[f"geolocation_data/{k}"][...], np.float64)
                fill = f[f"geolocation_data/{k}"].attrs.get("_FillValue")
                if fill is not None:
                    arr[arr == np.asarray(fill).ravel()[0]] = np.nan
                return np.ascontiguousarray(arr[::-1])  # north up

            return rd("latitude"), rd("longitude"), rd("height")


def _wrap_lon(lon):
    """Wrap longitudes into [-180, 180)."""
    return (lon + 180.0) % 360.0 - 180.0


def swath_corner_latlons(lat_img: np.ndarray, lon_img: np.ndarray) -> np.ndarray:
    """Bounding (lat, lon) corners of a multi-view granule swath.

    ``lat_img`` / ``lon_img`` are (H, W, views). The swath must be north-up
    (latitude falling along axis 0) and west-to-east (longitude rising along
    axis 1), and every image corner must have a valid view. Longitude
    extremes are taken relative to the swath's mean longitude, so a swath
    across the antimeridian orders west and east consistently, then shifted
    back and wrapped.

    Returns a (4, 2) float64 array of (lat, lon) rows: NW, NE, SW, SE.
    """
    if not np.nanmean(lat_img[-1, 0] - lat_img[0, 0]) < 0:
        raise ValueError("the swath is not north-up (latitude must fall along axis 0)")
    eastward = np.nanmean(lon_img[0, -1] - lon_img[0, 0]) % 360.0
    if not 0.0 < eastward < 180.0:
        raise ValueError("the swath does not run west to east along axis 1")

    centre = np.nanmean(lon_img)
    rel_lon = lon_img - centre

    # per corner: (row, col, latitude reducer, relative-longitude reducer)
    corner_spec = [
        (0, 0, np.nanmax, np.nanmin),  # NW
        (0, -1, np.nanmax, np.nanmax),  # NE
        (-1, 0, np.nanmin, np.nanmin),  # SW
        (-1, -1, np.nanmin, np.nanmax),  # SE
    ]
    corners = np.empty((4, 2), np.float64)
    for k, (r, c, reduce_lat, reduce_lon) in enumerate(corner_spec):
        if np.isnan(lat_img[r, c]).all() or np.isnan(lon_img[r, c]).all():
            raise ValueError(f"swath corner ({r}, {c}) has no valid view")
        corners[k, 0] = reduce_lat(lat_img[r, c])
        corners[k, 1] = _wrap_lon(reduce_lon(rel_lon[r, c]) + centre)
    return corners


def _centred_fractions(span: float, step: float) -> np.ndarray:
    """Fractions in (0, 1) placing ``int(span // step)`` points ``step``
    apart, half the remainder left as margin at each end."""
    count = int(span // step)
    margin = span % step
    return (np.linspace(0.0, span - margin, count) + margin / 2.0) / span


def geodesic_grid(corners: np.ndarray, step: float):
    """Near-uniform (lat, lon) grid over a quadrilateral swath.

    A plain lat/lon lattice would be unevenly spaced on the ellipsoid, so
    the grid follows Vincenty geodesics: its shape comes from the two
    midline spans, columns are anchored along the north and south edges,
    and each column is filled by walking the geodesic between its anchors.

    Args:
        corners: (4, 2) (lat, lon) rows ordered NW, NE, SW, SE.
        step: spacing of neighbouring grid points, in meters.

    Returns:
        ``(lat, lon)``, float64 arrays of (rows, cols).
    """
    # one batched inverse solve for the four edges: N, S, W, E
    edge_start = corners[[0, 2, 0, 1]].T  # (2, 4)
    edge_end = corners[[1, 3, 2, 3]].T
    edge_len, edge_azi, _ = wgs84.vincenty_distance(edge_start, edge_end)
    # one batched direct solve for the four edge midpoints
    mids, _ = wgs84.vincenty_point_along_geodesic(edge_start, edge_azi, edge_len / 2.0)
    # midline spans: rows = N-mid to S-mid, cols = W-mid to E-mid
    span_rows_cols, _, _ = wgs84.vincenty_distance(mids[:, [0, 2]], mids[:, [1, 3]])
    frac_rows = _centred_fractions(float(span_rows_cols[0]), step)
    frac_cols = _centred_fractions(float(span_rows_cols[1]), step)

    # anchor each column on the north and south edges, marched from the
    # western corner at the edge's forward azimuth
    anchors, _ = wgs84.vincenty_point_along_geodesic(
        corners[[0, 2]].T[:, :, None],  # (2, 2, 1): NW and SW starts
        edge_azi[:2, None],
        frac_cols[None, :] * edge_len[:2, None],
    )  # (2, 2, ncols): (lat|lon, N|S edge, col)
    north_anchor, south_anchor = anchors[:, 0], anchors[:, 1]

    # fill each column along its anchor-to-anchor geodesic
    col_len, col_azi, _ = wgs84.vincenty_distance(north_anchor, south_anchor)
    grid, _ = wgs84.vincenty_point_along_geodesic(
        north_anchor[:, None, :],
        col_azi[None, :],
        frac_rows[:, None] * col_len[None, :],
    )  # (2, nrows, ncols)
    return grid[0], grid[1]


class HARP2VoxelGridExtractDataset(_HARP2LocalExtractDataset):
    """A user-defined voxel grid, near-uniform horizontally despite the
    Earth's curvature (``geodesic_grid``), with bilinear DEM surface
    heights."""

    def __init__(
        self,
        dataset: HARP2Dataset,
        horizontal_step: float,
        alt_step: float,
        min_alt: float | None = None,
        max_alt: float | None = None,
        dem_path: str | Path = DEM_PATH,
        **_: object,
    ) -> None:
        super().__init__(dataset, alt_step, min_alt, max_alt)
        self.horizontal_step = horizontal_step

        nv = dataset.view_idx.shape[0]
        img_shape = list(dataset.img_shp) + [nv]
        corners = swath_corner_latlons(
            dataset.lat.reshape(img_shape).astype(np.float64),
            dataset.lon.reshape(img_shape).astype(np.float64),
        )
        sample_lat, sample_lon = geodesic_grid(corners, horizontal_step)

        self.height = interp_dem_height(dem_path, sample_lat, sample_lon)
        self.shp = sample_lat.shape + (self.sample_alt.shape[0],)
        self._grid_from_latlon(sample_lat, sample_lon)


def interp_dem_height(
    dem_path: str | Path, sample_lat: np.ndarray, sample_lon: np.ndarray
) -> np.ndarray:
    """Bilinear interpolation of the ETOPO1 DEM (the larger of land and
    water-surface height, clipped at 0) at the given coordinates, reading
    only the covering window of the file. A missing DEM gives zero heights
    with a warning."""
    dem_path = Path(dem_path)
    if not dem_path.exists():
        warnings.warn(f"DEM {dem_path} not found; using zero surface heights.")
        return np.zeros_like(sample_lat)
    import h5py

    with h5py.File(dem_path, "r") as f:

        def attr(name):
            return float(np.asarray(f.attrs[name]).ravel()[0])

        upper_lat = attr("upper_lat")
        left_lon = attr("left_lon")
        lat_res = attr("geospatial_lat_resolution")
        lon_res = attr("geospatial_lon_resolution")
        n_lat, n_lon = f["height"].shape

        loc_lat = (upper_lat - sample_lat) / lat_res
        loc_lon = (sample_lon - left_lon) / lon_res
        idx_lat = np.clip((loc_lat // 1).astype(int), 0, n_lat - 2).flatten()
        idx_lon = np.clip((loc_lon // 1).astype(int), 0, n_lon - 2).flatten()
        rem_lat = (loc_lat % 1).flatten()
        rem_lon = (loc_lon % 1).flatten()

        la0, la1 = idx_lat.min(), idx_lat.max() + 2
        lo0, lo1 = idx_lon.min(), idx_lon.max() + 2
        height = np.asarray(f["height"][la0:la1, lo0:lo1], np.float64)
        if "water_surface_height" in f:
            wsh = np.asarray(f["water_surface_height"][la0:la1, lo0:lo1], np.float64)
            height = np.maximum(height, wsh)
        idx_lat, idx_lon = idx_lat - la0, idx_lon - lo0

    corners = np.stack(
        [
            height[idx_lat, idx_lon],
            height[idx_lat, idx_lon + 1],
            height[idx_lat + 1, idx_lon],
            height[idx_lat + 1, idx_lon + 1],
        ]
    )
    weights = np.stack(
        [
            (1 - rem_lat) * (1 - rem_lon),
            (1 - rem_lat) * rem_lon,
            rem_lat * (1 - rem_lon),
            rem_lat * rem_lon,
        ]
    )
    interp = (corners * weights).sum(axis=0).reshape(sample_lat.shape)
    return np.clip(interp, 0, None)


def _voxel_keys(vox: np.ndarray, lo: np.ndarray, width: np.ndarray) -> np.ndarray:
    """One int64 per voxel row, ordered as the rows are lexicographically
    (``np.unique(rows, axis=0)``'s order): the offsets from ``lo`` in mixed
    radix ``width``."""
    rel = vox.astype(np.int64) - lo
    if np.any(rel < 0) or np.any(rel >= width):
        raise ValueError(native.OUTSIDE_BOX)
    return (rel[:, 0] * width[1] + rel[:, 1]) * width[2] + rel[:, 2]


def walk_keys_numpy(u: np.ndarray, end: np.ndarray, lo: np.ndarray,
                    width: np.ndarray) -> np.ndarray:
    """The plain version of ``native.voxel_keys``: the numpy walk, then
    ``_voxel_keys`` of its rows (the same set of keys; the numpy walk lists
    the start voxels once each, first)."""
    return _voxel_keys(voxel_traversal_numpy(u, end, unique_only=False), lo, width)


class HARP2GlobalGridExtractDataset(HARP2ExtractDataset):
    """A spherical-Earth voxel grid for large-scale visualization: rays to
    sphere coordinates, a vertical stretch, voxel traversal in chunks of
    ``_CHUNK_SIZE`` rays merged into one sorted set, a longitude crop per
    layer, then the stretch undone and points outside the atmosphere
    culled: ``(alt <= 0) | (alt > ray_origin_height)``.

    The same voxels, points and order as the JAX package's grid. The host
    library walks each chunk and writes each voxel's int64 key, checked
    against the rays' bounding box (``native.voxel_keys``; ``walk_keys``
    takes another walk of the same signature, such as
    ``walk_keys_numpy``), and the keys merge into one sorted set; the layers
    are cropped in one pass over the points sorted by layer, where the JAX
    package sorts float rows (``np.unique(axis=0)``) and loops over the
    layers."""

    def __init__(
        self,
        dataset: HARP2Dataset,
        scale: float,
        grid_res: float,
        vstretch: float | None = None,
        lon_crop: float = 0.05,
        walk_keys: Callable[..., np.ndarray] = native.voxel_keys,
        **_: object,
    ) -> None:
        super().__init__(dataset)
        vstretch = 1.0 if vstretch is None else vstretch
        if not vstretch >= 1:
            raise ValueError(f"vstretch {vstretch} must be at least 1")
        self.scale = scale
        self.grid_res = grid_res
        self.vstretch = vstretch

        ray_origin = sph.wgs_84_to_spherical(dataset.ray_origin.astype(np.float64))
        ray_dest = (dataset.ray_origin + dataset.ray_dir * dataset.ray_len[:, None]).astype(
            np.float64
        )
        ray_dest = sph.wgs_84_to_spherical(ray_dest)

        ray_origin = sph.stretch_above_sea_level(ray_origin, vstretch)
        ray_dest = sph.stretch_above_sea_level(ray_dest, vstretch)

        ray_origin *= scale / grid_res
        ray_dest *= scale / grid_res

        # a traversal may step one voxel past a segment's end
        ends = np.concatenate([ray_origin, ray_dest], axis=0)
        lo = np.floor(ends.min(axis=0)).astype(np.int64) - 1
        width = np.floor(ends.max(axis=0)).astype(np.int64) + 2 - lo
        keys = np.zeros((0,), np.int64)
        n = ray_origin.shape[0]
        for i in range(n // _CHUNK_SIZE + 1):
            start = min(n, i * _CHUNK_SIZE)
            end = min(n, start + _CHUNK_SIZE)
            if start == end:
                continue
            keys = np.union1d(keys, walk_keys(ray_origin[start:end], ray_dest[start:end],
                                              lo, width))
        rows = np.stack(
            [keys // (width[1] * width[2]), keys // width[2] % width[1], keys % width[2]],
            axis=1,
        ) + lo

        # voxel index -> voxel centre in spherical-scaled coordinates
        xyz = (rows.astype(np.float64) + 0.5) * (grid_res / scale)

        # crop the extreme longitudes of each z-layer (layers in rising z,
        # each layer's points in their order)
        order = np.argsort(rows[:, 2], kind="stable")
        xyz = xyz[order]
        lon_sph = np.arctan2(xyz[:, 1], xyz[:, 0])
        starts = np.flatnonzero(np.diff(rows[order, 2], prepend=rows[order[0], 2] - 1))
        counts = np.diff(np.append(starts, xyz.shape[0]))
        lon_min = np.minimum.reduceat(lon_sph, starts)
        lon_max = np.maximum.reduceat(lon_sph, starts)
        rng = lon_max - lon_min
        lo_lon = np.repeat(lon_min + lon_crop * rng, counts)
        hi_lon = np.repeat(lon_max - lon_crop * rng, counts)
        xyz = xyz[(lon_sph > lo_lon) & (lon_sph < hi_lon)]
        self.voxels = (xyz * (scale / grid_res)).astype(np.int32)

        xyz = sph.stretch_above_sea_level(xyz, 1.0 / vstretch)
        xyz = sph.spherical_to_wgs84(xyz)
        _, _, alt = wgs84.cartesian_to_horizontal(xyz[:, 0], xyz[:, 1], xyz[:, 2])
        cull = (alt <= 0) | (alt > dataset.config["ray_origin_height"])
        self.xyz = xyz[~cull]
        self.voxels = self.voxels[~cull]
        self.idx = np.arange(self.xyz.shape[0], dtype=np.int32)
        self.shp = (self.xyz.shape[0],)

    def dump(self, output_filepath: Path, sigma: np.ndarray) -> None:
        global_grid_dump(output_filepath, self, sigma)


class HARP2EarthCAREExtractDataset(HARP2ExtractDataset):
    """The sample points of an EarthCARE ATL_EBD_2A track under
    ``<data_root>/EarthCARE/``, for validation matchups: the columns whose
    every height lies inside the atmosphere, optionally a range of the
    track's profiles."""

    def __init__(
        self,
        dataset: HARP2Dataset,
        earthcare_filename: str,
        earthcare_range: list[int] | None = None,
        data_root: str | Path = "data",
        **_: object,
    ) -> None:
        super().__init__(dataset)
        if not (earthcare_range is None or (
            len(earthcare_range) == 2 and earthcare_range[1] > earthcare_range[0]
        )):
            raise ValueError(f"earthcare_range {earthcare_range}: want [start, end], end > start")
        self.earthcare_filename = earthcare_filename
        self.earthcare_range = earthcare_range

        import h5py

        path = Path(data_root) / "EarthCARE" / earthcare_filename
        self._h5_attrs = {}
        with h5py.File(path, "r") as f:
            file_type = f["HeaderData/FixedProductHeader/File_Type"][()]
            if isinstance(file_type, bytes):
                file_type = file_type.decode()
            if file_type != "ATL_EBD_2A":
                raise NotImplementedError(
                    f"Extraction currently only supports ATL_EBD_2A, not '{file_type}'."
                )
            self.alt = np.asarray(f["ScienceData/height"][:], np.float64)
            lat_1d = np.asarray(f["ScienceData/latitude"][:], np.float64)
            lon_1d = np.asarray(f["ScienceData/longitude"][:], np.float64)
            for key in ["latitude", "longitude", "height"]:
                ds = f[f"ScienceData/{key}"]
                self._h5_attrs[key] = {
                    k: (v.decode() if isinstance(v, bytes) else v) for k, v in ds.attrs.items()
                }
        self.lat = np.repeat(lat_1d[:, None], self.alt.shape[1], axis=1)
        self.lon = np.repeat(lon_1d[:, None], self.alt.shape[1], axis=1)

        if earthcare_range is not None:
            slc = slice(*earthcare_range)
            self.lat = self.lat[slc]
            self.lon = self.lon[slc]
            self.alt = self.alt[slc]

        mask_alt = (self.alt > 0).all(axis=0) & (
            self.alt < dataset.config["ray_origin_height"]
        ).all(axis=0)
        self.lat = self.lat[:, mask_alt]
        self.lon = self.lon[:, mask_alt]
        self.alt = self.alt[:, mask_alt]
        self.shp = self.lat.shape

        x, y, z = wgs84.horizontal_to_cartesian(
            self.lat.flatten(), self.lon.flatten(), self.alt.flatten()
        )
        self.xyz = np.stack([x, y, z], axis=1)
        self.idx = np.arange(self.xyz.shape[0], dtype=np.int32)

    def dump(self, output_filepath: Path, sigma: np.ndarray) -> None:
        earthcare_to_netcdf(output_filepath, self, sigma)
