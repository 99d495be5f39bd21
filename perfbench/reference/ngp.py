"""Instant-NGP with a surface branch, as the configuration files describe
it (Mueller et al. 2022, arXiv:2201.05989, with the AtmoNR surface branch):
the occupancy-grid sampler, the multiresolution hash encodings, the small
bias-free ReLU MLPs, spherical harmonics of the view direction,
Beer-Lambert compositing over an opaque surface, the ``mse_plus_hdr``
loss, the global-norm clip and AdamW.

Precision is the configuration's: the MLPs are ``FullyFusedMLP``s,
tiny-cuda-nn's half-precision networks, computed here as the port runs
them: inputs, weights and activations in bfloat16, products accumulated in
float32. A hash table's stored precision comes from ``fwd_mode`` (int8
per-level codes, with stochastic rounding where ``stochastic_rounding`` is
set, or bfloat16); its gradient is the float32 table's, straight through
the rounding. Everything else is float32. ``table_format`` replaces the
tables' stored precision (the lower-precision controls)."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

PRIMES = (1, 2654435761, 805459861)
DENSITY_OUT = 16  # width of the density MLP's output
SH_C0, SH_C1 = 0.28209479177387814, 0.48860251190291987


@dataclass(frozen=True)
class Grid:
    dims: int
    levels: int
    features: int
    log2_size: int
    base: int
    growth: float
    stored: str  # "q8", "bf16", "q4", "e4m3" or "f32"

    @staticmethod
    def of(options: dict, dims: int) -> "Grid":
        mode = options.get("fwd_mode", "auto")
        grid = Grid(dims, int(options["n_levels"]), int(options["n_features_per_level"]),
                    int(options["log2_hashmap_size"]), int(options["base_resolution"]),
                    float(options["per_level_scale"]), "bf16" if mode == "auto" else mode)
        if grid.stored == "q8" and max(grid.sizes) > (1 << 16):
            # int8 codes are kept to levels of at most 2^16 rows
            return dataclasses.replace(grid, stored="f32")
        return grid

    def scale(self, level: int) -> float:
        return math.pow(2.0, level * math.log2(self.growth)) * self.base - 1.0

    def resolution(self, level: int) -> int:
        return int(math.ceil(self.scale(level))) + 1

    @property
    def sizes(self) -> list[int]:
        out = []
        for level in range(self.levels):
            n = min(self.resolution(level) ** self.dims, 1 << self.log2_size)
            out.append(-(-n // 8) * 8)
        return out

    @property
    def offsets(self) -> list[int]:
        offs, total = [], 0
        for s in self.sizes:
            offs.append(total)
            total += s
        return offs

    @property
    def rows(self) -> int:
        return sum(self.sizes)


def corners_and_weights(x: torch.Tensor, grid: Grid, level: int):
    """Table rows (M, 2^D) of a level's cell corners (x bit fastest) and
    their D-linear weights."""
    res = grid.resolution(level)
    pos = x * grid.scale(level) + 0.5
    cell = torch.floor(pos)
    frac = pos - cell
    base = torch.clamp(cell.to(torch.int32), 0, res - 2).to(torch.int64)
    bits = torch.tensor([[(c >> d) & 1 for d in range(grid.dims)] for c in range(1 << grid.dims)],
                        device=x.device)
    g = base[:, None, :] + bits[None]
    if res**grid.dims <= grid.sizes[level]:
        idx = g[..., 0]
        stride = 1
        for d in range(1, grid.dims):
            stride *= res
            idx = idx + g[..., d] * stride
    else:
        idx = g[..., 0] * PRIMES[0] & 0xFFFFFFFF
        for d in range(1, grid.dims):
            idx = idx ^ (g[..., d] * PRIMES[d] & 0xFFFFFFFF)
        idx = idx & ((1 << grid.log2_size) - 1)
    f = torch.where(bits[None] == 1, frac[:, None, :], 1.0 - frac[:, None, :])
    w = f[..., 0]
    for d in range(1, grid.dims):
        w = w * f[..., d]
    return idx + grid.offsets[level], w


def _level_rows(grid: Grid, device) -> torch.Tensor:
    return torch.repeat_interleave(torch.arange(grid.levels, device=device),
                                   torch.tensor(grid.sizes, device=device))


def stored_table(table: torch.Tensor, grid: Grid, fmt: str, noise: torch.Tensor | None):
    """(decoded float32 table, per-level scale or None) of ``table`` kept in
    format ``fmt``: ``q8``/``q4`` symmetric integer codes of the level's
    largest magnitude over 127 / 7 (stochastic rounding with ``noise``),
    ``e4m3`` float8 codes under a power-of-two level scale, ``bf16`` the
    nearest bfloat16, ``f32`` the table itself."""
    if fmt == "f32":
        return table, None
    if fmt == "bf16":
        return table.to(torch.bfloat16).to(torch.float32), None
    rows = _level_rows(grid, table.device)
    amax = torch.zeros(grid.levels, device=table.device).scatter_reduce(
        0, rows, table.abs().amax(1), "amax", include_self=False).clamp(min=1e-30)
    if fmt == "e4m3":
        mant, exp = torch.frexp(amax / torch.full_like(amax, 448.0))
        scale = torch.ldexp(torch.ones_like(mant), torch.where(mant == 0.5, exp - 1, exp))
        return (table / scale[rows][:, None]).to(torch.float8_e4m3fn).to(torch.float32), scale
    top = {"q8": 127.0, "q4": 7.0}[fmt]
    scale = amax / torch.full_like(amax, top)
    t = table / scale[rows][:, None]
    q = torch.round(t) if noise is None else torch.floor(t + noise)
    return torch.clamp(q, -top, top), scale


def encode(table: torch.Tensor, x: torch.Tensor, grid: Grid, fmt: str | None = None,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """(M, D) positions -> (M, levels * features): the corner sum over the
    stored table, times the level's scale; differentiable in the float32
    table as the unrounded encoding is."""
    fmt = grid.stored if fmt is None else fmt
    with torch.no_grad():
        decoded, scale = stored_table(table, grid, fmt, noise)
    outs = []
    for level in range(grid.levels):
        idx, w = corners_and_weights(x, grid, level)
        with torch.no_grad():
            q = decoded[idx]
            acc = w[:, 0, None] * q[:, 0]
            for c in range(1, idx.shape[1]):
                acc = acc + w[:, c, None] * q[:, c]
            if scale is not None:
                acc = acc * scale[level]
        if torch.is_grad_enabled() and table.requires_grad:
            # the stored table's value, the float32 table's gradient: the
            # added term is exactly zero and carries the gradient
            exact = (w[..., None] * table[idx]).sum(1)
            acc = acc + (exact - exact.detach())
        outs.append(acc)
    return torch.cat(outs, -1)


def mlp(weights: list[torch.Tensor], x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """A bias-free ReLU MLP of (out, in) weights, computed in ``dtype``;
    the result in the input's dtype."""
    y = x.to(dtype)
    for i, w in enumerate(weights):
        y = y @ w.to(dtype).T
        if i < len(weights) - 1:
            y = torch.relu(y)
    return y.to(x.dtype)


def sh2(v: torch.Tensor) -> torch.Tensor:
    """Degree-2 real spherical harmonics, tiny-cuda-nn's component order and
    input mapping (x -> 2x - 1)."""
    v = v * 2.0 - 1.0
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.full_like(x, SH_C0), -SH_C1 * y, 0.48860251190291992 * z,
                        -SH_C1 * x], -1)


class Model:
    """The configuration's Instant-NGP pipeline over a ``Scene``."""

    def __init__(self, pipeline_cfg: dict, scene, table_format: str | None = None):
        ngp = pipeline_cfg["instant_ngp"]
        self.cfg = pipeline_cfg
        self.scene = scene
        self.pos = Grid.of(ngp["encoding"], 3)
        self.sr = bool(ngp["encoding"].get("stochastic_rounding", False))
        nested = ngp["surface_encoding"]["nested"]
        self.surf = Grid.of(nested[0], int(nested[0]["n_dims_to_encode"]))
        occ = pipeline_cfg["occupancy"]
        self.res = tuple(int(r) for r in occ["resolution"])
        self.n_probe, self.n_fine = int(occ["n_probe"]), int(occ["n_fine"])
        self.floor = float(occ["floor"])
        self.decay = float(occ["decay"])
        self.alt_compress = float(pipeline_cfg["alt_compress_factor"])
        self.table_format = table_format

    def fmt(self, grid: Grid) -> str:
        return self.table_format or grid.stored

    def unit(self, pts):
        return (self.scene.preprocess(pts) + 1.0) / 2.0

    def sample(self, rays, probe, fine, occ):
        """Occupancy-grid sampling: probes in equal bins, their grid values
        (over the per-ray maximum, plus the floor) as a piecewise-constant
        pdf, ``n_fine`` stratified inverse-CDF samples."""
        o, d, ln = rays["origin"], rays["dir"], rays["len"]
        n = self.n_probe
        z = (torch.arange(n, dtype=o.dtype, device=o.device) * (1.0 / n))[None] + probe / n
        pts = o[:, None] + d[:, None] * (z * ln[:, None])[..., None]
        u = self.unit(pts)
        rx, ry, rz = self.res
        i, j, k = (torch.clamp(torch.floor(u[..., a] * float(r)).to(torch.int64), 0, r - 1)
                   for a, r in enumerate(self.res))
        w = occ.reshape(-1)[(i * ry + j) * rz + k]
        w = w / (w.amax(-1, keepdim=True) + 1e-12) + self.floor
        pdf = w / w.sum(-1, keepdim=True)
        cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
        m = self.n_fine
        q = (torch.arange(m, dtype=o.dtype, device=o.device) / m)[None] + fine
        below = torch.clamp(torch.searchsorted(cdf.contiguous(), q.contiguous(), right=True) - 1,
                            0, n - 1)
        t = (q - torch.gather(cdf[:, :-1], 1, below)) / torch.clamp(torch.gather(pdf, 1, below),
                                                                      min=1e-12)
        z = (below.to(o.dtype) + torch.clamp(t, 0.0, 1.0)) / n * ln[:, None]
        return o[:, None] + d[:, None] * z[..., None], z

    def encoder_inputs(self, pts):
        u = self.unit(pts)
        return torch.cat([u[..., :2], (u[..., 2] / self.alt_compress)[..., None]], -1)

    def density(self, p: dict, x, noise=None):
        feats = encode(p["pos_table"], x, self.pos, self.fmt(self.pos), noise)
        return mlp(self.weights(p, "pos_mlp"), feats)

    @staticmethod
    def weights(p: dict, name: str) -> list[torch.Tensor]:
        n = sum(1 for k in p if k.startswith(name + ".layers."))
        return [p[f"{name}.layers.{i}.weight"] for i in range(n)]

    def render(self, p: dict, rays, draws: dict, occ):
        """Per-ray composited radiance in every band, (B, bands)."""
        b = rays["origin"].shape[0]
        with torch.no_grad():
            pts, z = self.sample(rays, draws["probe"], draws["fine"], occ)
            x = self.encoder_inputs(pts).reshape(-1, 3)
        n = z.shape[1]
        out = self.density(p, x, draws.get("sr_noise") if self.sr else None)
        dirs = rays["dir"][:, None].expand(b, n, 3).reshape(-1, 3)
        color = mlp(self.weights(p, "dir_mlp"), torch.cat([sh2(dirs), out[:, 1:]], -1))
        color = torch.relu(color).reshape(b, n, -1)
        sigma = torch.relu(out[:, :1]).reshape(b, n, 1)
        surf_pt = (rays["origin"] + rays["dir"] * rays["len"][:, None] + 1.0) / 2.0
        s_enc = encode(p["surf_enc.0"], surf_pt[:, :2], self.surf, self.fmt(self.surf))
        c_surf = torch.relu(mlp(self.weights(p, "surf_mlp"),
                                torch.cat([s_enc, sh2(rays["dir"])], -1)))
        zk = z * (self.scene.scale / 1000.0)
        mid = torch.cat([zk[:, :1] * 0, (zk[:, :-1] + zk[:, 1:]) * 0.5, zk[:, -1:]], -1)
        delta = torch.diff(mid, dim=-1)[..., None]
        alpha = 1.0 - torch.exp(-sigma * delta)
        trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], 1),
                              1)[:, :-1]
        atmo = torch.sum(color * (alpha * trans), 1)
        return atmo + torch.prod(1.0 - alpha, 1) * c_surf

    def loss(self, p: dict, rays, draws: dict, occ) -> torch.Tensor:
        """``mse_plus_hdr`` on each ray's own band, in units of the scene's
        largest radiance."""
        pred = torch.gather(self.render(p, rays, draws, occ), 1, rays["band"][:, None].long())[:, 0]
        gt, mi = rays["rad"], self.scene.max_i
        mse = torch.mean((pred / mi - gt / mi) ** 2)
        hdr = torch.mean((torch.log(gt + 1e-3 * mi) - torch.log(pred + 1e-3 * mi)) ** 2)
        return mse + 0.2 * hdr

    def refresh(self, p: dict, occ: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
        """The occupancy grid after a refresh: the density at one point a
        cell, ``jitter`` ((cells, 3) U[0,1)) placing it within the cell of
        the unit cube (x slowest), the tables rounded to nearest;
        ``max(occ * decay, sigma)``."""
        res = torch.tensor(self.res, dtype=torch.float32, device=occ.device)
        axes = [torch.arange(r, dtype=torch.float32, device=occ.device) for r in self.res]
        base = torch.stack([a.reshape(-1) for a in torch.meshgrid(*axes, indexing="ij")], -1)
        u = (base + jitter) / res
        x = torch.cat([u[:, :2], (u[:, 2] / self.alt_compress)[:, None]], -1)
        with torch.no_grad():
            sigma = torch.relu(self.density(p, x)[:, 0])
        return torch.maximum(occ * self.decay, sigma.reshape(self.res))

    def extinction(self, p: dict, pts: torch.Tensor) -> torch.Tensor:
        """Extinction (M,) at normalized points, in the units of ``pts``."""
        with torch.no_grad():
            return torch.relu(self.density(p, self.encoder_inputs(pts))[:, 0])


def is_table(name: str) -> bool:
    return name == "pos_table" or name.startswith("surf_enc.")


class AdamW:
    """AdamW (Loshchilov and Hutter) with decoupled weight decay on the MLPs
    only, behind the optional global-norm clip, at a constant rate."""

    def __init__(self, params: dict, opt_cfg: dict):
        self.p = params
        self.lr = float(opt_cfg["lr"])
        self.b1, self.b2 = (float(b) for b in opt_cfg["betas"])
        self.eps = float(opt_cfg["eps"])
        self.wd = float(opt_cfg.get("weight_decay", 0.0))
        clip = opt_cfg.get("clip_global_norm")
        self.clip = float(clip) if clip else None
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def clipped(self, grads: dict) -> dict:
        if self.clip is None:
            return grads
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if norm < self.clip:
            return grads
        return {k: g / norm * self.clip for k, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, p in self.p.items():
            g = grads[k]
            if not is_table(k):
                p.mul_(1.0 - self.lr * self.wd)
            self.m[k].lerp_(g, 1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def table_grids(pipeline_cfg: dict) -> dict[str, Grid]:
    """The hash grid of each table parameter."""
    ngp = pipeline_cfg["instant_ngp"]
    nested = ngp["surface_encoding"]["nested"]
    return {"pos_table": Grid.of(ngp["encoding"], 3),
            "surf_enc.0": Grid.of(nested[0], int(nested[0]["n_dims_to_encode"]))}


def param_shapes(pipeline_cfg: dict) -> dict[str, tuple[int, int]]:
    """Every parameter of the pipeline by name: the two hash tables (rows,
    features) and each MLP layer's (out, in) weight."""
    ngp = pipeline_cfg["instant_ngp"]
    pos = Grid.of(ngp["encoding"], 3)
    nested = ngp["surface_encoding"]["nested"]
    surf = Grid.of(nested[0], int(nested[0]["n_dims_to_encode"]))
    bands = int(pipeline_cfg["num_bands"])
    sh = int(ngp["dir_encoding"]["nested"][0]["degree"]) ** 2
    shapes = {"pos_table": (pos.rows, pos.features), "surf_enc.0": (surf.rows, surf.features)}
    nets = {"pos_mlp": (pos.levels * pos.features, DENSITY_OUT, ngp["network"]),
            "dir_mlp": (sh + DENSITY_OUT - 1, bands, ngp["rgb_network"]),
            "surf_mlp": (surf.levels * surf.features + sh, bands, ngp["surface_network"])}
    for name, (n_in, n_out, net) in nets.items():
        width, hidden = int(net["n_neurons"]), int(net["n_hidden_layers"])
        dims = [(width, n_in)] + [(width, width)] * hidden + [(n_out, width)]
        for i, d in enumerate(dims):
            shapes[f"{name}.layers.{i}.weight"] = d
    return shapes
