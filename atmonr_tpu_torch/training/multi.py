"""Multi-granule training: G granules trained at once, each with its own
model on its own devices. The counterpart of the JAX package's
``training/multi.py``.

Each granule is its own scene (normalization, bounds, ``max_i``), so each
gets its own dataset, pipeline and ``Trainer``, and ``train_granules``
round-robins their step generators. In one process, granule g trains on
``cuda:(g % device_count)`` (``Trainer.place``); a card that holds several
granules runs their steps in turns. Under torchrun the ranks split into
contiguous groups (``partition_devices`` over the ranks) and each group's
mesh trains one granule (``Trainer.shard``); a rank drives the granules of
its groups.
"""

from __future__ import annotations

import signal
from pathlib import Path

import torch


def partition_devices(n_granules: int, devices=None) -> list[list]:
    """Split ``devices`` (the visible cards by default; ranks under
    torchrun) into ``n_granules`` contiguous groups. With fewer devices
    than granules, groups share devices round-robin."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("no devices to partition")
    if n < n_granules:
        return [[devices[g % n]] for g in range(n_granules)]
    per = n // n_granules
    return [devices[g * per : (g + 1) * per] for g in range(n_granules)]


def _tagged_print(tag: str, *args, **kwargs) -> None:
    # the single-granule console line rewrites itself with end="\r";
    # interleaved trainers each get a prefixed, newline-terminated line
    kwargs.pop("end", None)
    text = " ".join(str(a) for a in args).rstrip()
    if text:
        print(f"[{tag}] {text}")
    else:
        print()


def train_granules(trainers: list, output_paths: list[str | Path], profile: bool = False) -> None:
    """Drive the trainers' step generators round-robin until all finish.

    SIGTERM is handled once and fans out to every trainer, so a
    preemption checkpoints every granule before returning (each through
    its own preemption path). If one granule raises, the others'
    generators are closed and their checkpoints waited for."""
    if len(trainers) != len(output_paths):
        raise ValueError(f"{len(trainers)} trainers for {len(output_paths)} output paths")

    def _on_sigterm(signum, frame):
        for t in trainers:
            t._preempted = True

    signal.signal(signal.SIGTERM, _on_sigterm)

    for g, t in enumerate(trainers):
        if t.is_main:
            t._print = lambda *a, _g=g, **k: _tagged_print(f"granule {_g}", *a, **k)

    gens = [
        t.iterate(p, profile=profile and g == 0)
        for g, (t, p) in enumerate(zip(trainers, output_paths))
    ]
    active = list(gens)
    try:
        while active:
            for gen in list(active):
                try:
                    next(gen)
                except StopIteration:
                    active.remove(gen)
    finally:
        # a granule that fails must not leave the others' checkpoint writes
        # in flight: close the surviving generators and wait on every
        # trainer's writer
        for gen in active:
            gen.close()
        for t in trainers:
            t.checkpointer.wait()
