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

import torch
from torch import nn

from atmonr_tpu_torch.utils.device import resolve_device


class Pipeline(nn.Module):
    """Base class; subclasses implement ``forward``, ``update_aux``,
    ``extract``, ``compute_loss`` and ``make_optimizer``."""

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
        self.config = config
        self.scale = dataset.scale
        self.offset = dataset.offset
        if config["point_preprocessor"]:
            self.point_preprocessor = dataset.get_point_preprocessor(
                config["point_preprocessor"]
            )
        else:
            self.point_preprocessor = None

    def init_aux(self) -> None:
        """Reset the non-learnable buffers (e.g. the occupancy grid)."""

    def update_aux(self, generator=None, jitter=None) -> None:
        """Periodic refresh of the buffers; nothing by default."""
