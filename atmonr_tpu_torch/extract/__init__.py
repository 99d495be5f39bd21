"""Extinction extraction."""

from atmonr_tpu_torch.extract.runner import run_extraction

__all__ = ["run_extraction"]
