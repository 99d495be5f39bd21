"""Device choice for the port's entry points: the card unless the caller
asks for another device."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when ``cuda`` is asked for, or implied, and there is no card:
    the port never carries on silently on the CPU. Pass ``device="cpu"``
    to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "atmonr_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
