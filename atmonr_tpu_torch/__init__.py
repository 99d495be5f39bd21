"""AtmoNR in PyTorch and CUDA, beside the JAX package ``atmonr_tpu``.

The Instant-NGP pipeline with its three samplers (occupancy grid,
importance, uniform), the pair-bucket hash and the height channel, and the
hierarchical NeRF pipeline (``NeRFPipeline``): training (``Trainer``, ``python -m
atmonr_tpu_torch.scripts.train``), ray rendering, the occupancy refresh,
the extinction query over the four extraction grids with their netCDF /
OpenVDB writers (``python -m atmonr_tpu_torch.scripts.extract``) and the
orbit video (``python -m atmonr_tpu_torch.scripts.make_video``). The
hash-encode forward over bf16, f32, int8 and float8 tables and the
hash-table gradient are CUDA kernels for sm_90a
(``csrc/``, built at first use). The measurement entry points are
``python -m atmonr_tpu_torch.bench`` (flagship train rays/s) and
``python -m atmonr_tpu_torch.tools.<name>`` (``utils/benchmark.py``'s
timing; the block fetch ``csrc/block_fetch.cu`` probes random-row gather
bandwidth), among them the quality harness (``tools/ab_importance.py``:
matched-wall-clock training and PSNR/SSIM over every ray) and the
real-granule-scale demo and quality A/B. Several devices go through
``torch.distributed`` (``parallel/``: the (data, sample) mesh, ``Trainer.shard``,
``extract --mesh``; ``training/multi.py``: one model per granule), one
process per device under torchrun. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``:

    from atmonr_tpu_torch import (
        NeRFPipeline, Trainer, get_dataset, get_extract_dataset, get_pipeline,
        load_config, run_extraction,
    )

This package imports ``torch`` and ``numpy``, and nothing of JAX or of
``atmonr_tpu``.
"""

from atmonr_tpu_torch.data.factory import get_dataset
from atmonr_tpu_torch.extract import get_extract_dataset, run_extraction
from atmonr_tpu_torch.pipelines.factory import get_pipeline
from atmonr_tpu_torch.pipelines.nerf import NeRFPipeline
from atmonr_tpu_torch.training import Trainer
from atmonr_tpu_torch.utils.config import load_config

__all__ = [
    "NeRFPipeline",
    "Trainer",
    "get_dataset",
    "get_extract_dataset",
    "get_pipeline",
    "load_config",
    "run_extraction",
]
