"""Instant-NGP pipeline with an occupancy grid and a separate surface branch:
the counterpart of the JAX package's ``pipelines/instant_ngp.py``.

Per ray batch: occupancy-grid probes at ``n_probe`` stratified points place
``n_fine`` samples by piecewise inverse CDF; the 3-D hash encoding of the
[0,1]-remapped, altitude-compressed points feeds the density MLP (16
outputs, the first 1-or-num_bands are densities); SH(dirs) + identity
(features) feed the color MLP; the surface branch hashes the remapped
surface point in 2-D, adds SH(dirs) and feeds the surface color MLP;
``render_with_surface`` composites. ``update_aux`` refreshes the occupancy
grid by a dense re-evaluation of the density branch, and ``extract``
queries extinction at scene points.

Both hash encodings run the q8 kernel (K1) when the config says
``fwd_mode: "q8"``, and their table gradients the scatter-add kernel (K2).
``forward`` runs under autograd; the inference entry points (``update_aux``,
``extract``) switch it off themselves. ``compute_loss`` selects the config's
loss on each ray's own band, and ``make_optimizer`` builds the clipped AdamW.
The uniform and importance samplers (configs without ``occupancy``) are
still to be ported.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from atmonr_tpu_torch.models import hash_grid as hg
from atmonr_tpu_torch.models.encoders import (
    apply_composite,
    composite_output_dim,
    hash_grid_configs,
    init_composite,
    parse_encoding_config,
)
from atmonr_tpu_torch.models.mlp import SmallMLP
from atmonr_tpu_torch.ops import occupancy
from atmonr_tpu_torch.ops.compositor import render_with_surface
from atmonr_tpu_torch.ops.losses import get_loss
from atmonr_tpu_torch.ops.samplers import sample_piecewise, sample_uniform_bins
from atmonr_tpu_torch.pipelines.base import Pipeline
from atmonr_tpu_torch.training.optim import ClippedAdamW
from atmonr_tpu_torch.training.schedules import apply_warmup

_POS_MLP_OUT = 16  # intermediate width of the density MLP


class InstantNGPPipeline(Pipeline):
    """Instant-NGP (Mueller et al. 2022) adapted to atmospheric satellite data.

    Parameters: ``pos_table`` (the 3-D hash table), ``pos_mlp``, ``dir_mlp``,
    ``surf_enc`` (the surface hash table of each HashGrid spec, keyed by its
    index in the composite) and ``surf_mlp``. Buffer: ``occ``, the occupancy
    grid. ``compute_dtype`` is bf16 for the MLP products (the tcnn fp16
    analog); parity checks set it to float32.
    """

    def __init__(
        self,
        config: dict,
        dataset,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__(config, dataset, device)
        self.num_density_outputs = (
            config["num_bands"] if config["multi_band_extinction"] else 1
        )
        if config["include_height"]:
            raise NotImplementedError(
                "include_height needs append_heights (ROADMAP.md queue 1, "
                "'The rest of the Instant-NGP pipeline')"
            )
        if not config.get("occupancy"):
            raise NotImplementedError(
                "only the occupancy-grid sampler is ported; the uniform and "
                "importance samplers are ROADMAP.md queue 1, 'The rest of the "
                "Instant-NGP pipeline'"
            )
        self.num_inputs = 3
        ngp = config["instant_ngp"]

        self.pos_cfg = hg.HashGridConfig.from_options(ngp["encoding"], self.num_inputs)
        # stochastic rounding of the q8 forward quantization (draws only:
        # eval and extraction round deterministically)
        self.pos_sr = bool(ngp["encoding"].get("stochastic_rounding", False))
        act = str(config.get("density_activation", "relu"))
        if act not in ("relu", "softplus"):
            raise ValueError(f"unknown density_activation {act!r}")
        self.density_act = torch.relu if act == "relu" else nn.functional.softplus
        shi = str(config.get("surface_head_init", "default"))
        if shi not in ("default", "quiet"):
            raise ValueError(f"unknown surface_head_init {shi!r}")
        self.surface_head_init = shi
        self.dir_specs = parse_encoding_config(ngp["dir_encoding"])
        self.dir_in_dims = 3 + _POS_MLP_OUT - self.num_density_outputs
        self.dir_enc_dims = composite_output_dim(self.dir_specs, self.dir_in_dims)
        self.surf_specs = parse_encoding_config(ngp["surface_encoding"])
        self.surf_in_dims = 2 + 3
        self.surf_enc_dims = composite_output_dim(self.surf_specs, self.surf_in_dims)
        self.surf_cfgs = hash_grid_configs(self.surf_specs, self.surf_in_dims)

        self.max_i = dataset.max_i
        self.loss_fn = get_loss(config["loss"])
        self.compute_dtype = torch.bfloat16
        self.occ_cfg = occupancy.OccupancyConfig.from_options(config["occupancy"])

        dev = self.device
        f = self.pos_cfg.n_features_per_level
        self.pos_table = nn.Parameter(torch.empty((self.pos_cfg.total_params, f), device=dev))
        self.surf_enc = nn.ParameterDict(
            {
                str(i): nn.Parameter(
                    torch.empty((c.total_params, c.n_features_per_level), device=dev)
                )
                for i, c in self.surf_cfgs.items()
            }
        )
        self.register_buffer("occ", occupancy.init_grid(self.occ_cfg, dev))
        self.init_params(generator if generator is not None else torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (hash tables
        U(-1e-4, 1e-4), MLPs Xavier-uniform)."""
        ngp = self.config["instant_ngp"]
        dev = self.device

        def mlp(in_dim, out_dim, net):
            return SmallMLP(
                in_dim, out_dim, int(net["n_neurons"]), int(net["n_hidden_layers"]),
                generator, dev,
            )

        with torch.no_grad():
            self.pos_table.copy_(hg.init_hash_table(self.pos_cfg, generator, dev))
            self.pos_mlp = mlp(self.pos_cfg.n_output_dims, _POS_MLP_OUT, ngp["network"])
            self.dir_mlp = mlp(self.dir_enc_dims, self.config["num_bands"], ngp["rgb_network"])
            for i, t in init_composite(self.surf_specs, self.surf_in_dims, generator, dev).items():
                self.surf_enc[str(i)].copy_(t)
            self.surf_mlp = mlp(
                self.surf_enc_dims, self.config["num_bands"], ngp["surface_network"]
            )
            if self.surface_head_init == "quiet":
                self.surf_mlp.layers[-1].weight.mul_(0.01)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Copy a parameter state dict (``convert.params_from_jax``'s
        layout) in; every parameter must be given, and nothing else."""
        own = dict(self.named_parameters())
        if set(params) != set(own):
            raise KeyError(
                f"parameter names differ: missing {sorted(set(own) - set(params))}, "
                f"unexpected {sorted(set(params) - set(own))}"
            )
        with torch.no_grad():
            for name, value in params.items():
                if own[name].shape != value.shape:
                    raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(own[name].shape)}")
                own[name].copy_(value)

    def _surf_tables(self) -> dict[int, torch.Tensor]:
        return {int(i): t for i, t in self.surf_enc.items()}

    def _pos_branch(
        self, pts_flat: torch.Tensor, sr_noise: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Hash-encode + density MLP over flattened points -> (M, 16)."""
        pos_enc = hg.hash_encode(self.pos_table, pts_flat, self.pos_cfg, sr_noise)
        return self.pos_mlp(pos_enc, compute_dtype=self.compute_dtype)

    # -- occupancy grid ------------------------------------------------------

    def init_aux(self) -> None:
        self.occ.fill_(1.0)

    @torch.no_grad()
    def update_aux(
        self,
        generator: torch.Generator | None = None,
        jitter: torch.Tensor | None = None,
    ) -> None:
        """Dense density re-evaluation at cell points -> EMA-max grid update,
        in place. The points are jittered within their cells by ``jitter``
        ((num_cells, 3) U[0,1)), or by draws from ``generator``; cell
        centers when both are None."""
        oc = self.occ_cfg
        if generator is not None:
            if jitter is not None:
                raise ValueError("pass a generator or jitter, not both")
            jitter = _uniform((oc.num_cells, 3), generator, self.device)
        u = occupancy.cell_points(oc, self.device, jitter)
        hash_in = torch.cat(
            [u[:, :2], u[:, 2:] / self.config["alt_compress_factor"]], dim=-1
        )
        pos_out = self._pos_branch(hash_in)
        sigma = self.density_act(
            torch.amax(pos_out[:, : self.num_density_outputs], dim=-1)
        )
        self.occ.copy_(occupancy.update_grid(self.occ, sigma, oc))

    # -- forward -------------------------------------------------------------

    def _unit_coords(self, pts: torch.Tensor) -> torch.Tensor:
        """Normalized scene points -> the preprocessed [0,1]^3 cube (the
        occupancy grid's space: post-preprocessor, pre altitude compression)."""
        if self.point_preprocessor:
            pts = self.point_preprocessor(pts)
        return (pts + 1.0) / 2.0

    def _encoder_inputs(self, pts: torch.Tensor) -> torch.Tensor:
        """Normalized scene points (B, N, 3) -> hash-encoder inputs: point
        preprocessor, [0,1] remap, altitude compression."""
        pts = self._unit_coords(pts)
        alt_c = pts[..., 2] / self.config["alt_compress_factor"]
        return torch.cat([pts[..., :2], alt_c[..., None], pts[..., 3:]], dim=-1)

    def make_draws(
        self, batch_size: int, generator: torch.Generator
    ) -> dict[str, torch.Tensor]:
        """The random draws of one stochastic forward, from ``generator``:
        ``sr_noise`` (pos-table shaped U[0,1), with stochastic rounding),
        ``probe`` ((B, n_probe) U[0,1) positions within the probe bins) and
        ``fine`` ((B, n_fine) U[0, 1/n_fine) quantile jitter)."""
        oc = self.occ_cfg
        draws = {}
        if self.pos_sr:
            draws["sr_noise"] = _uniform(tuple(self.pos_table.shape), generator, self.device)
        draws["probe"] = _uniform((batch_size, oc.n_probe), generator, self.device)
        draws["fine"] = _uniform(
            (batch_size, oc.n_fine), generator, self.device
        ) * (1.0 / oc.n_fine)
        return draws

    def _sample(
        self, ray_batch: Mapping[str, torch.Tensor], draws: Mapping[str, torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Occupancy-guided sample positions along rays -> (pts, z_vals, n)."""
        oc = self.occ_cfg
        pts_p, _ = sample_uniform_bins(ray_batch, oc.n_probe, draws.get("probe"))
        u = self._unit_coords(pts_p)
        w = occupancy.probe_weights(self.occ, u, oc)
        pts, z_vals = sample_piecewise(ray_batch, w, oc.n_fine, draws.get("fine"))
        return pts, z_vals, oc.n_fine

    @torch.no_grad()
    def sample_points(
        self,
        ray_batch: Mapping[str, torch.Tensor],
        draws: Mapping[str, torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The sample positions of one forward: the (B*n, 3) inputs of the
        position hash encoder and the (B, n) depths. They depend on the rays,
        the occupancy grid and the draws only, and carry no gradient."""
        pts, z_vals, _ = self._sample(ray_batch, draws or {})
        return torch.reshape(self._encoder_inputs(pts), (-1, self.num_inputs)), z_vals

    def forward(
        self,
        ray_batch: Mapping[str, torch.Tensor],
        generator: torch.Generator | None = None,
        draws: Mapping[str, torch.Tensor] | None = None,
    ) -> dict[str, torch.Tensor]:
        """One Instant-NGP render of a ray batch ("origin", "dir", "len").

        Deterministic (midpoint samples, round-to-nearest q8) when neither
        ``generator`` nor ``draws`` is given; otherwise the draws of
        ``make_draws``, made from ``generator`` or passed in. Differentiable
        in the parameters; the occupancy grid and the sample positions carry
        no gradient."""
        b = ray_batch["origin"].shape[0]
        if generator is not None:
            if draws is not None:
                raise ValueError("pass a generator or draws, not both")
            draws = self.make_draws(b, generator)
        draws = draws or {}
        sr_noise = draws.get("sr_noise") if self.pos_sr else None
        x, z_vals = self.sample_points(ray_batch, draws)
        n = z_vals.shape[1]
        pts_surf = ray_batch["origin"] + ray_batch["dir"] * ray_batch["len"][:, None]
        pts_surf = (pts_surf + 1.0) / 2.0

        dirs = ray_batch["dir"][:, None].expand(b, n, 3)

        pos_out = self._pos_branch(x, sr_noise)
        nd = self.num_density_outputs
        dir_in = torch.cat([torch.reshape(dirs, (b * n, 3)), pos_out[:, nd:]], dim=1)
        dir_enc = apply_composite({}, self.dir_specs, dir_in)
        color = self.dir_mlp(dir_enc, compute_dtype=self.compute_dtype)
        color = torch.reshape(color, (b, n, self.config["num_bands"]))

        surf_in = torch.cat([pts_surf[:, :2], dirs[:, 0]], dim=1)
        surf_enc = apply_composite(self._surf_tables(), self.surf_specs, surf_in)
        color_surf = self.surf_mlp(surf_enc, compute_dtype=self.compute_dtype)

        sigma = torch.reshape(pos_out[..., :nd], (b, n, -1))

        color = torch.relu(color)
        color_surf = torch.relu(color_surf)
        sigma = self.density_act(sigma)

        color_map, _, weights, color_map_atmo, color_map_surf = render_with_surface(
            z_vals * (self.scale / 1000.0), color, sigma, color_surf
        )
        return {
            "color_fine": color[:, :-1],
            "color_surf": color_surf,
            "color_map_surf": color_map_surf,
            "color_map_atmo": color_map_atmo,
            "sigma_fine": sigma[:, :-1],
            "color_map_fine": color_map,
            "weights_fine": weights,
            "z_vals_fine": z_vals,
        }

    def compute_loss(
        self, ray_batch: Mapping[str, torch.Tensor], results: Mapping[str, torch.Tensor]
    ) -> torch.Tensor:
        """The config's loss on each ray's own band."""
        pred = torch.gather(
            results["color_map_fine"], 1, ray_batch["irgb_idx"][:, None].long()
        )[:, 0]
        gt = ray_batch["rad"].to(pred.dtype)
        return self.loss_fn(pred, gt, self.max_i)

    def make_optimizer(self, optimizer_config: dict, lr_schedule) -> ClippedAdamW:
        """AdamW behind the global-norm clip; weight decay on the MLPs only,
        not on the hash tables. ``lr_schedule`` is a float or a function of
        the optimizer's step count; the config's warmup wraps it."""
        decay, no_decay = [], []
        for name, p in self.named_parameters():
            (no_decay if name == "pos_table" or name.startswith("surf_enc.") else decay).append(p)
        return ClippedAdamW(
            decay, no_decay, optimizer_config, apply_warmup(lr_schedule, optimizer_config)
        )

    @torch.no_grad()
    def extract(self, pts: torch.Tensor) -> torch.Tensor:
        """Extinction (M, num_density_outputs) at normalized-scene points
        (M, 3)."""
        pts = self._encoder_inputs(pts[None])[0]
        pos_out = self._pos_branch(pts)
        nd = self.num_density_outputs
        return self.density_act(pos_out[..., :nd].reshape(pts.shape[0], nd))


def _uniform(
    shape: tuple[int, ...], generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """U[0,1) f32 draws from ``generator`` on its own device, on ``device``."""
    return torch.rand(shape, generator=generator, device=generator.device).to(device)
