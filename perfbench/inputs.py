"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: granules, parameters, the rows of each step and the
step's random draws. Everything is drawn from seeded generators, so one
seed gives the same inputs on every run.

The two granule makers are frozen copies of the synthetic granules the
repository's tests and tools use: the HARP2 L1B granule in its real schema
(90 views, fill-coded pixels, striped red views; the arrays as a netCDF
reader returns them) and the small multi-view swath of the CLIs'
``synthetic:HxWxV`` scenes."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.ngp import is_table, param_shapes, table_grids

BAND_NM = {0: 867.0, 1: 669.0, 2: 550.0, 3: 441.0}
FILL = np.float32(-999.0)
VALID = {"lat": (-90, 90), "lon": (-180, 180), "alt": (-1000, 10000), "thetav": (0, 90),
         "phiv": (-180, 360), "i": (0, 800)}


def stream_seed(seed: int, *stream: int) -> int:
    """A well-mixed 63-bit seed for one of a run's streams."""
    return int(np.random.SeedSequence([seed, *stream]).generate_state(1, np.uint64)[0] >> 1)


def _as_read(arr, vmin=None, vmax=None):
    f32 = np.asarray(arr, np.float32)
    mask = f32 == FILL
    if vmin is not None:
        mask |= f32 < np.float32(vmin)
    if vmax is not None:
        mask |= f32 > np.float32(vmax)
    out = f32.astype(np.float64)
    out[mask] = np.nan
    return out


def real_schema_granule(height: int, width: int, seed: int, noise: float = 0.01) -> dict:
    """A HARP2 L1B granule in the real product's schema: 60 red views and 10
    each of infrared, green and blue, interleaved, at +-55-57 degrees; one
    smooth cloud; the swath-edge column and every other row of three red
    views fill-coded. The fields are (views, rows, cols), float64, NaN where
    invalid."""
    rng = np.random.default_rng(seed)
    bands = np.concatenate([np.full(60, 1), np.full(10, 0), np.full(10, 2), np.full(10, 3)])
    rng.shuffle(bands)
    n_views = bands.size
    spread = {0: 55.0, 1: 57.0, 2: 55.0, 3: 55.0}
    view_angles = np.empty(n_views)
    for b in range(4):
        m = bands == b
        view_angles[m] = np.linspace(-spread[b], spread[b], m.sum())
    wavelengths = np.array([BAND_NM[b] for b in bands])
    lat2, lon2 = np.meshgrid(18.0 + np.arange(height) * 0.02, -42.0 + np.arange(width) * 0.02,
                             indexing="ij")
    lat = lat2 + rng.normal(scale=1e-4, size=(n_views, height, width))
    lon = lon2 + rng.normal(scale=1e-4, size=(n_views, height, width))
    alt = np.abs(rng.normal(scale=30.0, size=lat.shape))
    thetav = np.abs(view_angles)[:, None, None] * np.ones((1, height, width))
    phiv = np.where(view_angles < 0, 260.0, 80.0)[:, None, None] * np.ones((1, height, width))
    yy, xx = np.meshgrid(np.linspace(-1, 1, height), np.linspace(-1, 1, width), indexing="ij")
    cloud = np.exp(-((yy**2 + xx**2) / 0.18))
    i_rad = (0.3 + 0.1 * bands[:, None, None] + cloud[None] * (1.2 - 0.05 * bands[:, None, None])
             + rng.normal(scale=noise, size=(n_views, height, width))).astype(np.float32)
    i_rad[:, :, 0] = FILL
    i_rad[np.flatnonzero(bands == 1)[:3], ::2, :] = FILL
    fields = {"lat": lat, "lon": lon, "alt": alt, "thetav": thetav, "phiv": phiv, "i": i_rad}
    out = {k: _as_read(v, *VALID[k]) for k, v in fields.items()}
    out.update(level="L1B", product_name="PACE_HARP2.20240101T000000.L1B.V3.SYNTHETIC.nc",
               view_angles=_as_read(view_angles), wavelengths=_as_read(wavelengths).flatten())
    return out


def swath_granule(height: int, width: int, views_per_band: int, seed: int) -> dict:
    """The small synthetic L1B swath: a regular 0.02-degree grid at 20N 40W,
    ``views_per_band`` views a band between -40 and 40 degrees, one smooth
    cloud, 2% of the radiances NaN."""
    rng = np.random.default_rng(seed)
    lat0, lon0, pixel_deg, max_angle = 20.0, -40.0, 0.02, 40.0
    n_views = 4 * views_per_band
    view_angles = np.linspace(-max_angle, max_angle, n_views)
    bands = np.tile(np.arange(4), views_per_band)
    rng.shuffle(bands)
    wavelengths = np.array([BAND_NM[b] for b in bands])
    lat2, lon2 = np.meshgrid(lat0 + np.arange(height) * pixel_deg,
                             lon0 + np.arange(width) * pixel_deg, indexing="ij")
    lat = np.broadcast_to(lat2, (n_views, height, width)).copy()
    lon = np.broadcast_to(lon2, (n_views, height, width)).copy()
    lat += rng.normal(scale=1e-4, size=lat.shape)
    lon += rng.normal(scale=1e-4, size=lon.shape)
    alt = np.abs(rng.normal(scale=30.0, size=lat.shape))
    thetav = np.abs(view_angles)[:, None, None] * np.ones((1, height, width))
    thetav += rng.normal(scale=0.05, size=thetav.shape)
    phiv = np.where(view_angles < 0, -90.0, 90.0)[:, None, None] * np.ones((1, height, width))
    phiv += rng.normal(scale=0.5, size=phiv.shape)
    cy, cx = lat0 + height * pixel_deg / 2, lon0 + width * pixel_deg / 2
    cloud = np.exp(-(((lat - cy) / (height * pixel_deg / 3)) ** 2
                     + ((lon - cx) / (width * pixel_deg / 3)) ** 2))
    band_scale = np.array([0.8, 1.0, 0.9, 0.7])[bands][:, None, None]
    view_scale = 1.0 - 0.3 * (np.abs(view_angles) / max_angle)[:, None, None]
    i = (0.2 + 0.8 * cloud) * band_scale * view_scale * 100.0
    i += rng.normal(scale=0.5, size=i.shape)
    i[rng.uniform(size=i.shape) < 0.02] = np.nan
    return {"level": "L1B", "product_name": "PACE_HARP2.SYNTHETIC.L1B.nc", "lat": lat, "lon": lon,
            "alt": alt, "thetav": thetav, "phiv": phiv, "i": i, "view_angles": view_angles,
            "wavelengths": wavelengths}


GRANULES = {"real_schema": real_schema_granule, "swath": swath_granule}


def make_granule(spec: dict, seed: int) -> dict:
    """The granule a traffic file names (``{"kind": ..., sizes}``), drawn
    from ``seed``."""
    args = {k: v for k, v in spec.items() if k != "kind"}
    return GRANULES[spec["kind"]](seed=stream_seed(seed, 1), **args)


def make_params(pipeline_cfg: dict, spec: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter, drawn on ``device`` in two calls: the hash tables
    U(-a_l, a_l) at level l, ``a_l = spec["table_amplitude"] * (r_0 / r_l)``
    for a level of resolution ``r_l`` (a smooth field, as a trained model's:
    the coarse levels carry the structure, a fine level's features change
    across its cell about as much as a coarse level's do), the MLP weights
    Xavier-uniform, and the output layers named in
    ``spec["positive_heads"]`` non-negative, as a trained model's are: its
    radiances lie well above zero, where the log term of the loss is
    smooth, and its extinction is positive where the field has structure
    (no seed draws an empty field)."""
    shapes = param_shapes(pipeline_cfg)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    tables = [k for k in shapes if is_table(k)]
    mlps = [k for k in shapes if not is_table(k)]
    sizes = {k: shapes[k][0] * shapes[k][1] for k in shapes}
    amp = float(spec["table_amplitude"])
    flat_t = torch.rand(sum(sizes[k] for k in tables), generator=g, device=device)
    flat_m = torch.rand(sum(sizes[k] for k in mlps), generator=g, device=device)
    grids = table_grids(pipeline_cfg)
    out, at = {}, 0
    for k in tables:
        g = grids[k]
        res = torch.tensor([g.resolution(0) / g.resolution(l) for l in range(g.levels)],
                           device=device)
        level_amp = torch.repeat_interleave(res, torch.tensor(g.sizes, device=device)) * amp
        out[k] = (flat_t[at:at + sizes[k]].view(shapes[k]) * 2.0 - 1.0) * level_amp[:, None]
        at += sizes[k]
    at = 0
    for k in mlps:
        o, i = shapes[k]
        u = flat_m[at:at + sizes[k]].view(o, i)
        u = u if k in spec.get("positive_heads", ()) else u * 2.0 - 1.0
        out[k] = u * (6.0 / (i + o)) ** 0.5
        at += sizes[k]
    return out


class Draws:
    """The rows and random draws of a run's steps: a permutation of the ray
    set an epoch (the last partial batch dropped); for a compared step the
    stochastic-rounding noise (table-shaped U[0,1), where the position grid
    rounds stochastically), the probe positions (B, n_probe) U[0,1) and the
    fine-sample jitter (B, n_fine) U[0, 1/n_fine); for a compared occupancy
    refresh the cell points' jitter (cells, 3) U[0,1)."""

    def __init__(self, pipeline_cfg: dict, n_rays: int, batch: int, seed: int, device):
        shapes = param_shapes(pipeline_cfg)
        ngp = pipeline_cfg["instant_ngp"]
        self.noise_shape = shapes["pos_table"] if ngp["encoding"].get("stochastic_rounding") else None
        occ = pipeline_cfg["occupancy"]
        self.n_probe, self.n_fine = int(occ["n_probe"]), int(occ["n_fine"])
        self.cells = int(np.prod([int(r) for r in occ["resolution"]]))
        self.n_rays, self.batch, self.device = n_rays, batch, device
        self.per_epoch = n_rays // batch
        self.g_perm = torch.Generator(device=device).manual_seed(stream_seed(seed, 3))
        self.g_draw = torch.Generator(device=device).manual_seed(stream_seed(seed, 4))
        self.perm = None
        self.step = 0

    def rows(self) -> torch.Tensor:
        """The next step's ray indices; a new permutation at each epoch's
        start."""
        i = self.step % self.per_epoch
        if i == 0:
            self.perm = torch.randperm(self.n_rays, generator=self.g_perm, device=self.device)
        self.step += 1
        return self.perm[i * self.batch:(i + 1) * self.batch]

    def draws(self) -> dict[str, torch.Tensor]:
        g, dev, b = self.g_draw, self.device, self.batch
        d = {}
        if self.noise_shape is not None:
            d["sr_noise"] = torch.rand(self.noise_shape, generator=g, device=dev)
        d["probe"] = torch.rand((b, self.n_probe), generator=g, device=dev)
        d["fine"] = torch.rand((b, self.n_fine), generator=g, device=dev) * (1.0 / self.n_fine)
        return d

    def jitter(self) -> torch.Tensor:
        return torch.rand((self.cells, 3), generator=self.g_draw, device=self.device)
