"""Pipeline base: scene capture and the interface of a pipeline.

The JAX package keeps configuration in the pipeline object and threads the
parameters through pure functions. Here a pipeline is an ``nn.Module``: its
parameters and buffers live in it, on ``device``, and ``forward`` /
``update_aux`` / ``extract`` read them. ``forward`` is differentiable in
the parameters; ``compute_loss`` and ``make_optimizer`` complete a train
step. Train/eval mode is a per-call
property as in the JAX package: ``forward`` with no generator and no draws
is the deterministic path.
"""

from __future__ import annotations

import warnings
from typing import Mapping

import torch
from torch import nn

from atmonr_tpu_torch.utils.device import resolve_device


class Pipeline(nn.Module):
    """Base class; subclasses implement ``init_params``, ``make_draws``,
    ``forward``, ``extract``, ``compute_loss`` and ``make_optimizer``, and
    where they keep buffers ``init_aux`` and ``update_aux``."""

    def __init__(
        self, config: dict, dataset, device: str | torch.device | None = None
    ) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.ray_origin_height = dataset.config["ray_origin_height"]
        if config["point_preprocessor"] == "horizontal" and config["include_height"]:
            raise ValueError(
                "point_preprocessor 'horizontal' excludes include_height"
            )
        L_x = config.get("encoder", {}).get("L_x")
        if not config["point_preprocessor"] and isinstance(L_x, list) and len(set(L_x)) > 1:
            warnings.warn(
                "Are you sure you want to use a variable encoding dimension "
                "for non-transformed coordinates?"
            )
        self.config = config
        self.scale = dataset.scale
        self.offset = dataset.offset
        if config["point_preprocessor"]:
            self.point_preprocessor = dataset.get_point_preprocessor(
                config["point_preprocessor"]
            )
        else:
            self.point_preprocessor = None

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

    def init_aux(self) -> None:
        """Reset the non-learnable buffers (e.g. the occupancy grid)."""

    def update_aux(self, generator=None, jitter=None) -> None:
        """Periodic refresh of the buffers; nothing by default."""
