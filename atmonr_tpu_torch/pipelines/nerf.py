"""Hierarchical (coarse + fine) NeRF pipeline: the counterpart of the JAX
package's ``pipelines/nerf.py``.

A coarse pass takes ``N_c`` stratified samples per ray; a fine pass draws
``N_f`` more by the inverse CDF of the coarse compositing weights and
re-evaluates them merged with the coarse ones. Each pass: the point
preprocessor, the optional height channel, the frequency encodings of points
(``L_x``, one count per axis) and directions (``L_d``), its AtmoNeRF (coarse:
one density channel; fine: one per band), the exp color activation clamped at
11, ReLU densities, and Beer-Lambert compositing with z in km. The loss sums
the coarse and fine MSE on each ray's own band; Adam trains both MLPs.

No hash grid and no kernel of the port's own: the device work is the MLPs'
float32 GEMMs (``nn.Linear``), as the JAX package computes them outside
Pallas. ``forward`` runs under autograd, and the fine samples carry the
gradient of the coarse weights through their inverse CDF, as in the
reference; ``extract`` switches autograd off.

Spans (``utils/spans.py``): each pass is ``nerf.coarse`` / ``nerf.fine``
(count: its points), with ``pipeline.sample`` (rays) around its sampling,
``nerf.encode`` (points) around the point preprocessor and both frequency
encodings, ``nerf.mlp`` (points) around its AtmoNeRF, and
``pipeline.render`` (rays) around the activations and the compositing;
``extract`` opens ``nerf.encode`` and ``nerf.mlp``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from atmonr_tpu_torch.models.encoders import positional_encoding
from atmonr_tpu_torch.models.mlp import get_nerf_models
from atmonr_tpu_torch.ops.compositor import render
from atmonr_tpu_torch.ops.samplers import append_heights, sample_pdf, sample_uniform_bins
from atmonr_tpu_torch.pipelines.base import Pipeline
from atmonr_tpu_torch.training.optim import ClippedAdamW
from atmonr_tpu_torch.training.schedules import apply_warmup
from atmonr_tpu_torch.utils import spans


class NeRFPipeline(Pipeline):
    """NeRF (https://arxiv.org/abs/2003.08934) adapted to atmospheric scenes.

    Parameters: ``coarse`` and ``fine``, two ``AtmoNeRF`` modules, drawn
    from ``generator`` (seed 0 when None)."""

    def __init__(
        self,
        config: dict,
        dataset,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__(config, dataset, device)
        self.n_coarse = int(config["sampler"]["N_c"])
        self.n_fine = int(config["sampler"]["N_f"])
        self.L_x = config["encoder"]["L_x"]
        self.L_d = config["encoder"]["L_d"]
        self.coarse, self.fine = get_nerf_models(
            hidden_dim=int(config["mlp_hidden_dim"]),
            N_lambda=int(config["num_bands"]),
            L_x=self.L_x,
            L_d=self.L_d,
            include_height=bool(config["include_height"]),
            generator=generator if generator is not None else torch.Generator().manual_seed(0),
            device=self.device,
        )

    def init_params(self, generator: torch.Generator) -> None:
        """Redraw both MLPs from ``generator``, the coarse first."""
        self.coarse.init_params(generator)
        self.fine.init_params(generator)

    def make_draws(
        self, batch_size: int, generator: torch.Generator
    ) -> dict[str, torch.Tensor]:
        """The random draws of one stochastic forward, from ``generator``:
        ``coarse_bins`` ((B, N_c) U[0,1) positions within the coarse bins),
        ``coarse_noise`` ((B*N_c, 1) N(0,1) density noise), ``fine_u`` ((B,
        N_f) U[0,1) quantiles) and ``fine_noise`` ((B*(N_c+N_f), num_bands)
        N(0,1))."""
        b, n_c, n_f = batch_size, self.n_coarse, self.n_fine
        gdev = generator.device

        def draw(fn, shape):
            return fn(shape, generator=generator, device=gdev).to(self.device)

        return {
            "coarse_bins": draw(torch.rand, (b, n_c)),
            "coarse_noise": draw(torch.randn, (b * n_c, 1)),
            "fine_u": draw(torch.rand, (b, n_f)),
            "fine_noise": draw(torch.randn, (b * (n_c + n_f), int(self.config["num_bands"]))),
        }

    def _encode_points(self, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Normalized scene points (..., 3) -> (the MLP's input points (...,
        3 or 4): preprocessor, optional height channel; their frequency
        encoding (prod(...), pos_channels))."""
        if self.point_preprocessor:
            pts = self.point_preprocessor(pts)
        if self.config["include_height"]:
            pts = append_heights(pts, self.ray_origin_height, self.scale, self.offset)
        return pts, torch.reshape(positional_encoding(pts, self.L_x), (-1, self.coarse.pos_channels))

    def _forward(
        self,
        mode: str,
        ray_batch: Mapping[str, torch.Tensor],
        draws: Mapping[str, torch.Tensor],
        weights_coarse: torch.Tensor | None = None,
        z_vals_coarse: torch.Tensor | None = None,
    ) -> dict[str, torch.Tensor]:
        """One stage of the hierarchical forward."""
        b = ray_batch["origin"].shape[0]
        n = self.n_coarse if mode == "coarse" else self.n_coarse + self.n_fine
        with spans.span(f"nerf.{mode}", count=b * n):
            with spans.span("pipeline.sample", count=b):
                if mode == "coarse":
                    pts, z_vals = sample_uniform_bins(ray_batch, n, draws.get("coarse_bins"))
                else:
                    pts, z_vals = sample_pdf(
                        ray_batch, weights_coarse, z_vals_coarse, self.n_fine, draws.get("fine_u")
                    )
            with spans.span("nerf.encode", count=b * n):
                pts, pts_enc = self._encode_points(pts)
                dirs = ray_batch["dir"][:, None].expand(b, n, 3)
                dirs_enc = torch.reshape(positional_encoding(dirs, self.L_d), (b * n, -1))
            model = self.coarse if mode == "coarse" else self.fine
            with spans.span("nerf.mlp", count=b * n):
                color, sigma = model(
                    torch.cat([pts_enc, dirs_enc], dim=1), draws.get(f"{mode}_noise")
                )
            with spans.span("pipeline.render", count=b):
                color = torch.reshape(color, (b, n, -1))
                sigma = torch.reshape(sigma, (b, n, -1))

                # exp color activation, clamped at 11 against fp16 overflow
                color = torch.exp(torch.clamp(color, max=11.0))
                sigma = torch.relu(sigma)
                color_map, _, weights = render(z_vals * (self.scale / 1000.0), color, sigma)
        results = {
            f"color_{mode}": color,
            f"sigma_{mode}": sigma,
            f"color_map_{mode}": color_map,
            f"weights_{mode}": weights,
            f"z_vals_{mode}": z_vals,
        }
        if self.config["include_height"]:
            results[f"norm_heights_{mode}"] = pts[..., 3]
        return results

    def forward(
        self,
        ray_batch: Mapping[str, torch.Tensor],
        generator: torch.Generator | None = None,
        draws: Mapping[str, torch.Tensor] | None = None,
    ) -> dict[str, torch.Tensor]:
        """One hierarchical render of a ray batch ("origin", "dir", "len").

        Deterministic (bin midpoints, quantile midpoints, no density noise)
        when neither ``generator`` nor ``draws`` is given; otherwise the
        draws of ``make_draws``, made from ``generator`` or passed in."""
        if generator is not None:
            if draws is not None:
                raise ValueError("pass a generator or draws, not both")
            draws = self.make_draws(ray_batch["origin"].shape[0], generator)
        draws = draws or {}
        results = self._forward("coarse", ray_batch, draws)
        results.update(
            self._forward(
                "fine",
                ray_batch,
                draws,
                weights_coarse=results["weights_coarse"],
                z_vals_coarse=results["z_vals_coarse"],
            )
        )
        return results

    def compute_loss(
        self, ray_batch: Mapping[str, torch.Tensor], results: Mapping[str, torch.Tensor]
    ) -> torch.Tensor:
        """Coarse plus fine MSE on each ray's own band."""
        irgb = ray_batch["irgb_idx"][:, None].long()
        gt = ray_batch["rad"]
        loss = 0.0
        for mode in ("coarse", "fine"):
            pred = torch.gather(results[f"color_map_{mode}"], 1, irgb)[:, 0]
            loss = loss + torch.mean((pred - gt.to(pred.dtype)) ** 2)
        return loss

    def make_optimizer(self, optimizer_config: dict, lr_schedule) -> ClippedAdamW:
        """Adam over both MLPs: optax.adam's rule (betas (0.9, 0.999), eps
        1e-8, no clip, no weight decay) behind the config's warmup, whatever
        else the config names, as the JAX package builds it."""
        return ClippedAdamW(
            self.parameters(), [], {}, apply_warmup(lr_schedule, optimizer_config)
        )

    @torch.no_grad()
    def extract(self, pts: torch.Tensor) -> torch.Tensor:
        """Extinction (M, num_bands) of the fine model at normalized-scene
        points (M, 3)."""
        m = pts.shape[0]
        with spans.span("nerf.encode", count=m):
            _, pts_enc = self._encode_points(pts[None])
        with spans.span("nerf.mlp", count=m):
            _, sigma = self.fine.forward_pos_only(pts_enc.to(torch.float32))
        return torch.clamp(sigma, min=0)
