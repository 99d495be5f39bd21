"""Dataset registry + construction.

``get_dataset`` resolves a scene filename to a granule: a local file under
``<data_root>/HARP2/`` (read with h5py), or a generated synthetic granule
for the reserved name ``synthetic[:HxWxV[:hard]]``, so the whole slice runs
offline. Earthdata downloads are not ported.
"""

from __future__ import annotations

from pathlib import Path

import torch

from atmonr_tpu_torch.data.granule import GranuleArrays, read_granule
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.utils.device import resolve_device

BANDS = {"HARP2": 4}

DATASETS = {"HARP2": HARP2Dataset}


def _synthetic_from_name(filename: str) -> GranuleArrays:
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule

    if ":" in filename:
        # "synthetic:HxWxV" or "synthetic:HxWxV:hard" (multi-scale cloud field)
        parts = filename.split(":")
        h, w, v = (int(x) for x in parts[1].split("x"))
        n_blobs = 40 if len(parts) > 2 and parts[2] == "hard" else 1
        return make_synthetic_granule(
            height=h, width=w, views_per_band=v, n_blobs=n_blobs
        )
    return make_synthetic_granule()


def get_dataset(
    config: dict,
    filename: str,
    data_root: str | Path = "data",
    device: str | torch.device | None = None,
) -> HARP2Dataset:
    """Build the Dataset for ``config["type"]`` and ``filename``, its rays
    bound for ``device`` (``cuda`` unless the caller names another)."""
    device = resolve_device(device)
    if config["type"] not in DATASETS:
        raise NotImplementedError(
            f"No dataset registered under {config['type']!r}; "
            f"known types: {sorted(DATASETS)}"
        )
    if filename.startswith("synthetic"):
        granule = _synthetic_from_name(filename)
    else:
        local = Path(data_root) / "HARP2" / filename
        if not local.exists():
            raise FileNotFoundError(
                f"HARP2 file {filename} not found under {local.parent}; place "
                "the granule there or use the 'synthetic' scene name"
            )
        granule = read_granule(local)
    return DATASETS[config["type"]](config, granule, device=device)
