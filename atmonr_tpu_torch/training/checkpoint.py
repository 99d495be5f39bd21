"""Checkpoints: one ``torch.save`` file per epoch, ``<output>/epoch_NNNN.pt``,
restore-latest by epoch number (the role Orbax directories play in the JAX
package). A checkpoint is a plain dict of tensors, state dicts and Python
scalars; it is written to a temporary name and renamed, so a killed run
leaves no half-written latest file."""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

_EPOCH_RE = re.compile(r"epoch_(\d+)\.pt$")


def save_checkpoint(output_path: str | Path, epoch: int, state: dict[str, Any]) -> Path:
    """Save ``state`` as ``<output>/epoch_{epoch:04d}.pt``."""
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    path = output_path / f"epoch_{epoch:04d}.pt"
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(output_path: str | Path) -> int | None:
    """Highest saved epoch number, or None."""
    epochs = [
        int(m.group(1))
        for p in Path(output_path).glob("epoch_*.pt")
        if (m := _EPOCH_RE.search(p.name))
    ]
    return max(epochs) if epochs else None


def restore_checkpoint(
    output_path: str | Path, epoch: int | None = None
) -> tuple[dict[str, Any], int]:
    """Load the given (or latest) epoch's checkpoint, its tensors on the
    CPU: ``load_state_dict`` copies parameters, buffers and moments to their
    owners' device, and leaves AdamW's step counts on the host, where the
    optimizer reads them without waiting for the card. Returns (state,
    epoch)."""
    output_path = Path(output_path)
    if epoch is None:
        epoch = latest_epoch(output_path)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {output_path}")
    state = torch.load(
        output_path / f"epoch_{epoch:04d}.pt", map_location="cpu", weights_only=True
    )
    return state, epoch


def restore_params(output_path: str | Path, pipeline, epoch: int | None = None) -> int:
    """Load the given (or latest) checkpoint's pipeline state (parameters
    and, where there is one, the occupancy grid) into ``pipeline``, on its
    device: extraction and rendering need no optimizer state. Reads the
    port's own checkpoints, not the JAX package's Orbax directories.
    Returns the epoch."""
    state, epoch = restore_checkpoint(output_path, epoch)
    pipeline.load_state_dict(state["pipeline"])
    return epoch
