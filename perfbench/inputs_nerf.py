"""What the benchmark makes from ``--seed`` for the NeRF cells and hands to
both the program and the reference: both AtmoNeRFs' parameters, and the
rows and random draws of each step. The granule is ``inputs.py``'s."""

from __future__ import annotations

import torch

from perfbench import inputs
from perfbench.reference.nerf import param_shapes


def make_params(pipeline_cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter, drawn on ``device`` in two calls, as the published
    AtmoNeRF initializes its layers: each weight (out, in) Kaiming fan-out
    normal, ``N(0, 2 / out)``, each bias torch-Linear's ``U(-1/sqrt(in),
    1/sqrt(in))``."""
    shapes = param_shapes(pipeline_cfg)
    g = torch.Generator(device=device).manual_seed(inputs.stream_seed(seed, 2))
    weights = [k for k in shapes if k.endswith(".weight")]
    biases = [k for k in shapes if k.endswith(".bias")]
    size = lambda k: shapes[k][0] * (shapes[k][1] if len(shapes[k]) > 1 else 1)  # noqa: E731
    flat_w = torch.randn(sum(size(k) for k in weights), generator=g, device=device)
    flat_b = torch.rand(sum(size(k) for k in biases), generator=g, device=device)
    out, at = {}, 0
    for k in weights:
        o, i = shapes[k]
        out[k] = flat_w[at:at + o * i].view(o, i) * (2.0 / o) ** 0.5
        at += o * i
    at = 0
    for k in biases:
        (o,) = shapes[k]
        fan_in = shapes[k.replace(".bias", ".weight")][1]
        out[k] = (flat_b[at:at + o] * 2.0 - 1.0) / fan_in**0.5
        at += o
    return {k: out[k] for k in shapes}


class Draws(inputs.Draws):
    """The rows of a run's steps (``inputs.Draws.rows``: a permutation of
    the ray set an epoch) and, for a compared step, the draws of the
    stochastic forward: ``coarse_bins`` (B, N_c) U[0,1) positions in the
    coarse bins, ``coarse_noise`` (B N_c, 1) and ``fine_noise`` (B (N_c +
    N_f), bands) N(0,1) density noise, ``fine_u`` (B, N_f) U[0,1) quantiles
    of the fine samples."""

    def __init__(self, pipeline_cfg: dict, n_rays: int, batch: int, seed: int, device):
        self.n_c = int(pipeline_cfg["sampler"]["N_c"])
        self.n_f = int(pipeline_cfg["sampler"]["N_f"])
        self.bands = int(pipeline_cfg["num_bands"])
        self.n_rays, self.batch, self.device = n_rays, batch, device
        self.per_epoch = n_rays // batch
        self.g_perm = torch.Generator(device=device).manual_seed(inputs.stream_seed(seed, 3))
        self.g_draw = torch.Generator(device=device).manual_seed(inputs.stream_seed(seed, 4))
        self.perm = None
        self.step = 0

    def draws(self) -> dict[str, torch.Tensor]:
        g, dev, b, n_c, n_f = self.g_draw, self.device, self.batch, self.n_c, self.n_f
        return {"coarse_bins": torch.rand((b, n_c), generator=g, device=dev),
                "coarse_noise": torch.randn((b * n_c, 1), generator=g, device=dev),
                "fine_u": torch.rand((b, n_f), generator=g, device=dev),
                "fine_noise": torch.randn((b * (n_c + n_f), self.bands), generator=g,
                                          device=dev)}
