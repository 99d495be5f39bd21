"""Pipelines: Instant-NGP and hierarchical NeRF."""

from atmonr_tpu_torch.pipelines.factory import get_pipeline
from atmonr_tpu_torch.pipelines.instant_ngp import InstantNGPPipeline
from atmonr_tpu_torch.pipelines.nerf import NeRFPipeline

__all__ = ["InstantNGPPipeline", "NeRFPipeline", "get_pipeline"]
