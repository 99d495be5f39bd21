"""Device choice for the port's entry points (the card unless the caller
asks for another device), and the name of the device a result ran on."""

from __future__ import annotations

import subprocess

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


def describe_device(device: torch.device) -> str:
    """The device a result was measured on: for a card, its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (the name alone where nvidia-smi does not answer); else the
    device type."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(index)
    return smi or torch.cuda.get_device_name(index)
