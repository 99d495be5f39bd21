"""Narrow bias-free ReLU MLPs: the role tiny-cuda-nn's ``FullyFusedMLP``
plays in the reference, as in the JAX package's ``models/mlp.py``
(``small_mlp_*``). Weights are stored (out, in) and applied as
``x @ w.T``, the ``nn.Linear`` convention; products go to ``torch.matmul``.
The NeRF MLP is still to be ported.
"""

from __future__ import annotations

import torch
from torch import nn


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
