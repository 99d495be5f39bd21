"""Extraction grid registry."""

from __future__ import annotations

from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.extract.datasets import (
    HARP2EarthCAREExtractDataset,
    HARP2ExtractDataset,
    HARP2GlobalGridExtractDataset,
    HARP2L1CExtractDataset,
    HARP2VoxelGridExtractDataset,
)
from atmonr_tpu_torch.utils import spans

EXTRACT_DATASETS = {
    "HARP2": {
        "l1c": HARP2L1CExtractDataset,
        "voxelgrid": HARP2VoxelGridExtractDataset,
        "globalgrid": HARP2GlobalGridExtractDataset,
        "earthcare": HARP2EarthCAREExtractDataset,
    },
}


def get_extract_dataset(mode: str, dataset: HARP2Dataset, **kwargs) -> HARP2ExtractDataset:
    """Build the extraction grid of coordinate mode ``mode`` (``l1c``,
    ``voxelgrid``, ``globalgrid`` or ``earthcare``) over ``dataset``; each
    grid takes the keyword arguments it needs and ignores the rest."""
    data_type = dataset.config["type"]
    if data_type not in EXTRACT_DATASETS:
        raise NotImplementedError(
            f"No extract dataset registered under {data_type!r}; "
            f"known types: {sorted(EXTRACT_DATASETS)}"
        )
    with spans.span("extract.grid", cpu=True) as build:
        grid = EXTRACT_DATASETS[data_type][mode.lower()](dataset, **kwargs)
        build.count = len(grid)
    return grid
