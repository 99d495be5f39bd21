"""HARP2 dataset: granule -> ray tensors on the device.

Counterpart of the JAX package's ``data/harp2.py``: the ray set is built
once on the host in float64 numpy (meter-accurate), and ``rays(device)``
hands it to the device as a dict of tensors. The point preprocessor
(``SceneTransform.preprocess_points``) runs on device tensors in their own
dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from atmonr_tpu_torch.data.granule import GranuleArrays, get_indexes, parse_field
from atmonr_tpu_torch.geo import wgs84
from atmonr_tpu_torch.utils.device import resolve_device

RAY_CHUNK = int(1e4)

@dataclass(frozen=True)
class SceneTransform:
    """Static scene normalization: ECEF <-> normalized scene coordinates and
    the "horizontal" point preprocessor (normalized lat/lon/alt), including
    the dateline longitude shift. All fields are Python scalars."""

    scale: float
    offset: tuple[float, float, float]
    lat_min: float
    lat_range: float
    lon_min: float
    lon_range: float
    ray_origin_height: float
    shift_lon: bool

    def preprocess_points(self, pts: torch.Tensor) -> torch.Tensor:
        """Normalized-scene Cartesian -> normalized (lat, lon, alt) in [-1,1].

        Runs on ``pts``'s device in its dtype: float32 in the render path,
        where the ~1-6 m altitude error floor of the float32 conversion is
        ~3e-4 of the 20 km normalization."""
        xyz = [pts[..., i] * self.scale + self.offset[i] for i in range(3)]
        lat, lon, alt = wgs84.cartesian_to_horizontal(*xyz, xp=torch)
        if self.shift_lon:
            lon = lon % 360.0 - 180.0
        lat = 2.0 * (lat - self.lat_min) / self.lat_range - 1.0
        lon = 2.0 * (lon - self.lon_min) / self.lon_range - 1.0
        alt = 2.0 * alt / self.ray_origin_height - 1.0
        coords = torch.stack([lat, lon, alt], dim=-1).to(pts.dtype)
        return torch.clamp(coords, -1.0, 1.0)


class HARP2Dataset:
    """Loads a HARP2 granule and builds the normalized ray set.

    Host-side numpy float64 throughout construction (geolocation accuracy);
    ``rays()`` puts the arrays on ``device``. Fields as in the JAX package:
    ``scale``, ``offset``, ``max_i``, ``img_shp``, ``view_idx``,
    ``irgb_idx``. Rays are built with the numpy float64 path
    (``geo.wgs84.get_rays``). The config's ``rgb_mode`` (the RGB view pick
    of the image writers, not ported yet) is accepted and not read.
    """

    def __init__(
        self,
        config: dict,
        granule: GranuleArrays,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = dict(config)
        self.config.setdefault("max_abs_view_angle", 90.0)
        self.granule = granule

        self.view_idx, self.irgb_idx = get_indexes(
            granule,
            self.config["max_abs_view_angle"],
            self.config.get("bands_to_keep"),
        )
        level = granule.level
        self.img_shp = (
            granule.i.shape[1:] if level == "L1B" else granule.i.shape[:2]
        )

        pf = lambda a: parse_field(a, level, self.view_idx)  # noqa: E731
        self.lat = pf(granule.lat)
        self.lon = pf(granule.lon)
        self.alt = pf(granule.alt)
        self.thetav = pf(granule.thetav)
        self.phiv = pf(granule.phiv)
        self.int_arr = pf(granule.i)
        self.max_i = float(np.nanmax(self.int_arr))

        self._init_ray_data(RAY_CHUNK)
        self._device_rays: dict[str, torch.Tensor] | None = None

    def _init_ray_data(self, chunk_size: int) -> None:
        num_rays = self.lat.shape[0] * self.lat.shape[1]
        ray_origin = np.zeros((num_rays, 3), np.float32)
        ray_dir = np.zeros((num_rays, 3), np.float32)
        ray_len = np.zeros((num_rays,), np.float32)

        total = 0
        n_rows = self.lat.shape[0]
        for ci in range(-(-n_rows // chunk_size)):
            slc = slice(ci * chunk_size, min((ci + 1) * chunk_size, n_rows))
            o, d, ln = wgs84.get_rays(
                self.lat[slc],
                self.lon[slc],
                self.alt[slc],
                self.thetav[slc],
                self.phiv[slc],
                self.config["ray_origin_height"],
            )
            n = o.shape[0]
            ray_origin[total : total + n] = o
            ray_dir[total : total + n] = d
            ray_len[total : total + n] = ln
            total += n
        ray_rad = self.int_arr.flatten()

        self.ray_filter = wgs84.filter_rays(ray_origin, ray_dir, ray_rad)
        ray_origin = ray_origin[self.ray_filter]
        ray_dir = ray_dir[self.ray_filter]
        self.ray_rad = ray_rad[self.ray_filter]
        self.ray_len = ray_len[self.ray_filter]
        self.ray_alt = self.alt.flatten()[self.ray_filter]
        self.ray_origin = ray_origin
        self.ray_dir = ray_dir
        origin_norm, self.scale, offset = wgs84.normalize_rays(
            ray_origin, ray_dir, self.ray_len
        )
        self.ray_origin_norm = origin_norm
        self.offset = np.asarray(offset, np.float64)
        self.ray_len_norm = (self.ray_len / self.scale).astype(np.float32)
        nv = self.view_idx.shape[0]
        self.ray_irgb_idx = self.irgb_idx[
            np.where(self.ray_filter.reshape((-1, nv)))[1]
        ].astype(np.int32)
        self.num_rays = int(self.ray_origin_norm.shape[0])

        # scene transform for the "horizontal" preprocessor
        non_nan_lat = self.lat[~np.isnan(self.lat)]
        non_nan_lon = self.lon[~np.isnan(self.lon)]
        lat_min, lat_max = float(non_nan_lat.min()), float(non_nan_lat.max())
        lon_min, lon_max = float(non_nan_lon.min()), float(non_nan_lon.max())
        shift_lon = lon_max > 179 and lon_min < -179
        if shift_lon:
            shifted = non_nan_lon % 360 - 180
            lon_min, lon_max = float(shifted.min()), float(shifted.max())
        self.scene_transform = SceneTransform(
            scale=self.scale,
            offset=tuple(float(v) for v in self.offset),
            lat_min=lat_min,
            lat_range=lat_max - lat_min,
            lon_min=lon_min,
            lon_range=lon_max - lon_min,
            ray_origin_height=float(self.config["ray_origin_height"]),
            shift_lon=shift_lon,
        )

    def host_rays(self) -> dict[str, np.ndarray]:
        """The ray set as host numpy arrays."""
        return {
            "origin": self.ray_origin_norm,
            "dir": self.ray_dir,
            "alt": self.ray_alt,
            "rad": self.ray_rad,
            "len": self.ray_len_norm,
            "irgb_idx": self.ray_irgb_idx,
        }

    def rays(self, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
        """The ray set as tensors on ``device`` (the dataset's by default);
        the dataset's own copy is made once and kept."""
        dev = self.device if device is None else resolve_device(device)
        if dev == self.device and self._device_rays is not None:
            return self._device_rays
        rays = {k: torch.from_numpy(v).to(dev) for k, v in self.host_rays().items()}
        if dev == self.device:
            self._device_rays = rays
        return rays

    def target_image(self) -> np.ndarray:
        """(H, W, V) radiance image with invalid pixels zero-filled."""
        return self.scatter_image(self.ray_rad)

    def scatter_image(self, pixel_values: np.ndarray) -> np.ndarray:
        """(num_rays,) per-ray values -> (H, W, V) image at valid locations."""
        nv = self.view_idx.shape[0]
        img = np.zeros((self.img_shp[0] * self.img_shp[1] * nv), np.float32)
        img[self.ray_filter] = pixel_values
        return img.reshape(self.img_shp[0], self.img_shp[1], nv)

    def get_point_preprocessor(self, kind: str):
        """Preprocessor factory: ``"horizontal"`` only."""
        if kind == "horizontal":
            return self.scene_transform.preprocess_points
        raise NotImplementedError(kind)

    def __len__(self) -> int:
        return self.num_rays
