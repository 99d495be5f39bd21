"""Extinction extraction: the grids, their writers, the batched query and
the orbit renderer."""

from atmonr_tpu_torch.extract.factory import EXTRACT_DATASETS, get_extract_dataset
from atmonr_tpu_torch.extract.runner import run_extraction

__all__ = ["EXTRACT_DATASETS", "get_extract_dataset", "run_extraction"]
