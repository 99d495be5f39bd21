"""Checkpoints: one ``torch.save`` file per epoch, ``<output>/epoch_NNNN.pt``,
restore-latest by epoch number (the role Orbax directories play in the JAX
package). A checkpoint is a plain dict of tensors, state dicts and Python
scalars; it is written to a temporary name and renamed, so a killed run
leaves no half-written latest file. ``AsyncCheckpointManager`` writes in a
background thread from host copies, so training goes on during the write."""

from __future__ import annotations

import os
import re
import threading
import time
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


class AsyncCheckpointManager:
    """Per-epoch saves that overlap the training after them, the counterpart
    of the JAX package's ``AsyncCheckpointManager``.

    ``save`` first waits for the previous write, then copies every tensor of
    ``state`` to host memory: a card's tensors into pinned buffers that are
    kept for the next save (one non-blocking copy each, then a synchronize
    of the card's current stream), the host's into clones. Only then does
    one background thread ``save_checkpoint`` the copies. So a checkpoint
    holds the state as it was when ``save`` returned, however the caller
    updates the live tensors in place afterwards (``state_dict()`` returns
    the live parameters and optimizer moments). An exception in the writer
    is raised by the next ``wait``, ``save`` or ``close``, once.
    ``last_write_s`` is the background write's wall time."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pinned: dict[tuple, torch.Tensor] = {}
        self.last_write_s: float | None = None

    def save(self, output_path: str | Path, epoch: int, state: dict[str, Any]) -> Path:
        """Start writing ``state`` as ``<output>/epoch_{epoch:04d}.pt``;
        returns that path once ``state`` is copied."""
        self.wait()
        devices: set[torch.device] = set()
        snapshot = self._snapshot(state, (), devices)
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        self._thread = threading.Thread(
            target=self._write, args=(output_path, epoch, snapshot), name="checkpoint-writer"
        )
        self._thread.start()
        return Path(output_path) / f"epoch_{epoch:04d}.pt"

    def _snapshot(self, obj: Any, path: tuple, devices: set) -> Any:
        if isinstance(obj, torch.Tensor):
            if not obj.is_cuda:
                return obj.detach().clone()
            buf = self._pinned.get(path)
            if buf is None or buf.shape != obj.shape or buf.dtype != obj.dtype:
                buf = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
                self._pinned[path] = buf
            buf.copy_(obj.detach(), non_blocking=True)
            devices.add(obj.device)
            return buf
        if isinstance(obj, dict):
            return {k: self._snapshot(v, path + (k,), devices) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._snapshot(v, path + (i,), devices) for i, v in enumerate(obj))
        return obj

    def _write(self, output_path: str | Path, epoch: int, snapshot: dict[str, Any]) -> None:
        try:
            t0 = time.perf_counter()
            save_checkpoint(output_path, epoch, snapshot)
            self.last_write_s = time.perf_counter() - t0
        except BaseException as e:  # handed to the caller's thread by wait()
            self._error = e

    def wait(self) -> None:
        """Block until the write in flight, if any, has landed; raise its
        exception if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def close(self) -> None:
        """``wait``, then free the pinned buffers."""
        try:
            self.wait()
        finally:
            self._pinned.clear()


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
