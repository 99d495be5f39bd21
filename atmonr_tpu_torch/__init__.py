"""AtmoNR in PyTorch and CUDA, beside the JAX package ``atmonr_tpu``.

The Instant-NGP pipeline with the occupancy grid: training (``Trainer``,
``python -m atmonr_tpu_torch.scripts.train``), ray rendering, the occupancy
refresh and the extinction query. The q8 hash-encode forward and the
hash-table gradient are CUDA kernels for sm_90a (``csrc/``, built at first
use). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``:

    from atmonr_tpu_torch import (
        Trainer, get_dataset, get_pipeline, load_config, run_extraction,
    )

This package imports ``torch`` and ``numpy``, and nothing of JAX or of
``atmonr_tpu``.
"""

from atmonr_tpu_torch.data.factory import get_dataset
from atmonr_tpu_torch.extract.runner import run_extraction
from atmonr_tpu_torch.pipelines.factory import get_pipeline
from atmonr_tpu_torch.training import Trainer
from atmonr_tpu_torch.utils.config import load_config

__all__ = ["Trainer", "get_dataset", "get_pipeline", "load_config", "run_extraction"]
