"""Pipelines: Instant-NGP."""

from atmonr_tpu_torch.pipelines.factory import get_pipeline

__all__ = ["get_pipeline"]
