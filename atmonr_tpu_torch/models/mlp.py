"""The MLPs of both pipelines, as in the JAX package's ``models/mlp.py``.

- ``AtmoNeRF``: the 11-layer NeRF MLP with the positional skip connection,
  a density head and a view-dependent color head; Kaiming fan-out weights
  and torch-Linear biases (``linear_init``); the training-time Gaussian
  density noise comes in as a tensor of draws.
- ``SmallMLP``: the narrow bias-free ReLU MLPs, the role tiny-cuda-nn's
  ``FullyFusedMLP`` plays in the reference (``small_mlp_*``).

Weights are stored (out, in) and applied as ``x @ w.T``, the ``nn.Linear``
convention; products go to ``torch.matmul``, in float32 for AtmoNeRF.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def linear_init(
    out_dim: int, in_dim: int, generator: torch.Generator, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight (out, in), bias (out,)) of one AtmoNeRF layer, drawn from
    ``generator`` on its own device and moved to ``device``: the weight
    Kaiming fan-out normal (std ``sqrt(2 / out)``), the bias torch-Linear's
    U(-1/sqrt(in), 1/sqrt(in))."""
    gdev = generator.device
    w = torch.randn((out_dim, in_dim), generator=generator, device=gdev) * (2.0 / out_dim) ** 0.5
    bound = 1.0 / in_dim**0.5
    b = torch.empty((out_dim,), device=gdev).uniform_(-bound, bound, generator=generator)
    return w.to(device), b.to(device)


def atmonerf_layer_dims(
    pos_channels: int,
    dir_channels: int,
    out_channels: int,
    volume_channels: int,
    hidden_dim: int,
) -> list[tuple[int, int]]:
    """(out, in) dims of fc1..fc11."""
    h = hidden_dim
    return [
        (h, pos_channels),  # fc1
        (h, h),  # fc2
        (h, h),  # fc3
        (h, h),  # fc4
        (h, h),  # fc5
        (h, h + pos_channels),  # fc6 (skip concat)
        (h, h),  # fc7
        (h, h),  # fc8
        (h + volume_channels, h),  # fc9
        (h // 2, h + dir_channels),  # fc10
        (out_channels, h // 2),  # fc11
    ]


def atmonerf_channel_counts(
    L_x: int | Sequence[int], L_d: int, include_height: bool
) -> tuple[int, int]:
    """(pos_channels, dir_channels) of the frequency encodings: 2 sin/cos
    channels per frequency and axis (3 axes, plus the height with
    ``include_height``; a list ``L_x`` has one count per axis)."""
    if isinstance(L_x, int):
        pos_channels = L_x * 6
        if include_height:
            pos_channels += L_x * 2
    else:
        if len(L_x) != (4 if include_height else 3):
            raise ValueError(
                f"L_x {list(L_x)} needs one count per axis: 3, or 4 with include_height"
            )
        pos_channels = sum(L_x) * 2
    return pos_channels, L_d * 6


class AtmoNeRF(nn.Module):
    """NeRF MLP adapted to atmospheric scenes: ``fc1``..``fc11`` biased
    ``nn.Linear`` layers (``weight`` is the JAX package's ``w``, ``bias``
    its ``b``). ``volume_channels`` densities (1 for the coarse model,
    one per band for the fine) and ``out_channels`` colors."""

    def __init__(
        self,
        pos_channels: int,
        dir_channels: int,
        out_channels: int,
        volume_channels: int,
        hidden_dim: int,
        generator: torch.Generator,
        device: torch.device,
    ) -> None:
        super().__init__()
        self.pos_channels = pos_channels
        self.hidden_dim = hidden_dim
        dims = atmonerf_layer_dims(
            pos_channels, dir_channels, out_channels, volume_channels, hidden_dim
        )
        for i, (o, i_) in enumerate(dims):
            self.add_module(
                f"fc{i + 1}", nn.utils.skip_init(nn.Linear, i_, o, device=device)
            )
        self.init_params(generator)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Redraw every layer from ``generator`` (``linear_init``), fc1 first."""
        for i in range(1, 12):
            layer = getattr(self, f"fc{i}")
            w, b = linear_init(*layer.weight.shape, generator, layer.weight.device)
            layer.weight.copy_(w)
            layer.bias.copy_(b)

    def forward_pos_only(
        self, x_pos: torch.Tensor, noise: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Position branch up to the density head: (M, pos_channels) ->
        (features (M, hidden + volume), sigma (M, volume)). ``noise``
        (draws shaped like sigma, N(0,1) in training) is added to sigma
        before its ReLU."""
        relu = torch.relu
        x = relu(self.fc1(x_pos))
        x = relu(self.fc2(x))
        x = relu(self.fc3(x))
        x = relu(self.fc4(x))
        x = relu(self.fc5(x))
        x = torch.cat([x, x_pos], dim=1)  # skip connection
        x = relu(self.fc6(x))
        x = relu(self.fc7(x))
        x = relu(self.fc8(x))
        x = self.fc9(x)
        sigma = x[:, self.hidden_dim :]
        if noise is not None:
            sigma = sigma + noise
        return x, relu(sigma)

    def forward(
        self, x: torch.Tensor, noise: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """x = [pos_enc | dir_enc] -> (color (M, out) in (0, 1), sigma
        (M, volume)); the pipeline applies the exp color activation."""
        x_pos, d = x[:, : self.pos_channels], x[:, self.pos_channels :]
        feats, sigma = self.forward_pos_only(x_pos, noise)
        h = torch.cat([feats[:, : self.hidden_dim], d], dim=1)
        h = torch.relu(self.fc10(h))
        return torch.sigmoid(self.fc11(h)), sigma


def get_nerf_models(
    hidden_dim: int,
    N_lambda: int,
    L_x: int | Sequence[int],
    L_d: int,
    include_height: bool,
    generator: torch.Generator,
    device: torch.device,
) -> tuple[AtmoNeRF, AtmoNeRF]:
    """Coarse (1 density channel) and fine (one density per band)
    AtmoNeRFs, the coarse drawn first."""
    pos_ch, dir_ch = atmonerf_channel_counts(L_x, L_d, include_height)
    coarse = AtmoNeRF(pos_ch, dir_ch, N_lambda, 1, hidden_dim, generator, device)
    fine = AtmoNeRF(pos_ch, dir_ch, N_lambda, N_lambda, hidden_dim, generator, device)
    return coarse, fine


def small_mlp_init(
    in_dim: int,
    out_dim: int,
    n_neurons: int,
    n_hidden_layers: int,
    generator: torch.Generator,
    device: torch.device,
) -> list[torch.Tensor]:
    """Layer weights (out, in) of in -> [n_neurons]*(n_hidden_layers+1) ->
    out, Xavier-uniform (tcnn's default), drawn from ``generator`` on its
    own device and moved to ``device``."""
    dims = [(n_neurons, in_dim)]
    dims += [(n_neurons, n_neurons)] * n_hidden_layers
    dims.append((out_dim, n_neurons))
    weights = []
    for o, i in dims:
        bound = (6.0 / (i + o)) ** 0.5
        w = torch.empty((o, i), dtype=torch.float32, device=generator.device)
        weights.append(w.uniform_(-bound, bound, generator=generator).to(device))
    return weights


def small_mlp_apply(
    weights: list[torch.Tensor],
    x: torch.Tensor,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Forward through the narrow MLP; ReLU between layers, linear output.

    ``compute_dtype`` (e.g. bfloat16) casts weights and activations for the
    matmul chain; the output comes back in the input dtype."""
    in_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    n = len(weights)
    for i, w in enumerate(weights):
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        x = torch.matmul(x, w.T)
        if i < n - 1:
            x = torch.relu(x)
    return x.to(in_dtype)


class SmallMLP(nn.Module):
    """``small_mlp_apply`` over ``nn.Linear(bias=False)`` layers, whose
    ``weight`` is the (out, in) matrix of the JAX package's ``w``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        n_neurons: int,
        n_hidden_layers: int,
        generator: torch.Generator,
        device: torch.device,
    ) -> None:
        super().__init__()
        weights = small_mlp_init(
            in_dim, out_dim, n_neurons, n_hidden_layers, generator, device
        )
        self.layers = nn.ModuleList()
        for w in weights:
            layer = nn.utils.skip_init(
                nn.Linear, w.shape[1], w.shape[0], bias=False, device=device
            )
            with torch.no_grad():
                layer.weight.copy_(w)
            self.layers.append(layer)

    def forward(
        self, x: torch.Tensor, compute_dtype: torch.dtype | None = None
    ) -> torch.Tensor:
        return small_mlp_apply([layer.weight for layer in self.layers], x, compute_dtype)
