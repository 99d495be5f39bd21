"""Pipeline registry."""

from __future__ import annotations

import torch

from atmonr_tpu_torch.pipelines.base import Pipeline
from atmonr_tpu_torch.pipelines.instant_ngp import InstantNGPPipeline
from atmonr_tpu_torch.pipelines.nerf import NeRFPipeline

_PIPELINES = {"InstantNGP": InstantNGPPipeline, "NeRF": NeRFPipeline}


def get_pipeline(
    config: dict,
    dataset,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
) -> Pipeline:
    """Build the pipeline named by ``config["type"]`` on ``device`` (``cuda``
    unless the caller names another), its parameters drawn from
    ``generator`` (seed 0 when None)."""
    pipeline_type = config["type"]
    if pipeline_type not in _PIPELINES:
        raise NotImplementedError(
            f"No pipeline registered under {pipeline_type!r}; "
            f"known types: {sorted(_PIPELINES)}"
        )
    return _PIPELINES[pipeline_type](config, dataset, device=device, generator=generator)
