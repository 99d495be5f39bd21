"""A HARP2 granule as the reference reads it: the kept views in band
order, the pixel-view fields north up, the rays with their radiance and
band, the normalization box, and the horizontal point preprocessor."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference import geo


def kept_views(view_angles, wavelengths, max_abs_angle: float, bands_to_keep):
    """The views within ``max_abs_angle``, sorted by falling wavelength,
    and each one's band (0 infrared, 1 red, 2 green, 3 blue)."""
    order = np.argsort(-wavelengths, stable=True)
    views = order[np.isin(order, np.flatnonzero(np.abs(view_angles) <= max_abs_angle))]
    band = np.searchsorted(-np.unique(wavelengths)[::-1], -wavelengths[views])
    keep = np.isin(band, bands_to_keep)
    return views[keep], band[keep]


def pixel_view(field: np.ndarray, views: np.ndarray) -> np.ndarray:
    """(views, rows, cols) L1B field -> (pixels, kept views) float32, rows
    flipped to put north on top. The copy keeps the transposed layout, so
    a float32 mean over the views sums in the product's order."""
    return field[views, ::-1].transpose(1, 2, 0).reshape(-1, views.size).astype(np.float32)


@dataclass
class Scene:
    rays: dict  # origin (normalized), dir, len (normalized), rad, band: (N, ...) tensors
    scale: float
    offset: np.ndarray
    max_i: float
    box: tuple  # lat_min, lat_range, lon_min, lon_range
    origin_height: float
    lat: np.ndarray  # (pixels, views) float32
    lon: np.ndarray
    alt: np.ndarray
    image_shape: tuple

    def preprocess(self, pts: torch.Tensor) -> torch.Tensor:
        """Normalized points -> normalized (lat, lon, alt) in [-1, 1], in the
        points' dtype."""
        xyz = [pts[..., i] * self.scale + float(self.offset[i]) for i in range(3)]
        lat, lon, alt = geo.to_geodetic(*xyz)
        lat_min, lat_range, lon_min, lon_range = self.box
        out = torch.stack([2.0 * (lat - lat_min) / lat_range - 1.0,
                           2.0 * (lon - lon_min) / lon_range - 1.0,
                           2.0 * alt / self.origin_height - 1.0], -1).to(pts.dtype)
        return torch.clamp(out, -1.0, 1.0)


def build_scene(granule: dict, dataset_cfg: dict, device: torch.device,
                dtype=torch.float64) -> Scene:
    """The reference's rays of a granule (a dict of the L1B arrays), the
    geodesy in ``dtype``."""
    views, band = kept_views(granule["view_angles"], granule["wavelengths"],
                             dataset_cfg.get("max_abs_view_angle", 90.0),
                             dataset_cfg.get("bands_to_keep", [0, 1, 2, 3]))
    f = {k: pixel_view(granule[k], views) for k in ("lat", "lon", "alt", "thetav", "phiv", "i")}
    height = float(dataset_cfg["ray_origin_height"])
    t = {k: torch.from_numpy(v.reshape(-1)).to(device) for k, v in f.items()}
    origin, direction, length = geo.build_rays(t["lat"], t["lon"], t["alt"], t["thetav"],
                                               t["phiv"], height, dtype=dtype)
    rad = t["i"]
    ok = ~(torch.isnan(origin).any(1) | torch.isnan(direction).any(1) | torch.isnan(rad))
    origin, direction, length, rad = origin[ok], direction[ok], length[ok], rad[ok]
    ray_band = torch.from_numpy(band).to(device).repeat(f["lat"].shape[0])[ok]
    ends = origin + direction * length[:, None]
    both = torch.cat([origin, ends], 0)
    hi, lo = both.amax(0).double().cpu().numpy(), both.amin(0).double().cpu().numpy()
    scale = float(np.max(hi - lo) / 2.0)
    offset = (hi + lo) / 2.0
    off_t = torch.from_numpy(offset).to(device)
    origin_n = torch.clamp((origin.double() - off_t) / scale, -1.0, 1.0).to(torch.float32)
    lat_ok, lon_ok = f["lat"][~np.isnan(f["lat"])], f["lon"][~np.isnan(f["lon"])]
    lat_min, lat_max = float(lat_ok.min()), float(lat_ok.max())
    lon_min, lon_max = float(lon_ok.min()), float(lon_ok.max())
    if lon_max > 179 and lon_min < -179:
        raise NotImplementedError("a granule across the dateline")
    rays = {"origin": origin_n, "dir": direction, "len": length / torch.full_like(length, scale),
            "rad": rad, "band": ray_band}
    shape = granule["lat"].shape[1:]
    return Scene(rays, scale, offset, float(np.nanmax(f["i"])),
                 (lat_min, lat_max - lat_min, lon_min, lon_max - lon_min), height,
                 f["lat"], f["lon"], f["alt"], tuple(shape))
