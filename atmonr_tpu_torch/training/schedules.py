"""Learning-rate schedules, as in the JAX package's
``training/schedules.py``, as plain functions of the optimizer's step count
(0 for the first update) that return a Python float.

- ``target_lr``: per-epoch exponential decay with gamma chosen to land on
  ``final_lr`` after ``num_epochs`` (stepped at epoch boundaries).
- ``fixed``: multiply by ``gamma`` every ``decay_interval`` iterations once
  past ``decay_start``.

Warmup (optimizer ``warmup_iters``) is applied where the optimizer is built
(``make_optimizer`` via ``apply_warmup``), not here.
"""

from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def apply_warmup(lr_or_schedule: float | Schedule, optimizer_config: dict):
    """Wrap a float LR or a step schedule with a linear ramp over the first
    ``warmup_iters`` steps of the optimizer config (0 or absent: no-op).
    With eps = 1e-15 the first AdamW updates are near sign-magnitude while
    the second moments are tiny; the ramp lets them calibrate first."""
    warmup = int(optimizer_config.get("warmup_iters", 0))
    if not warmup:
        return lr_or_schedule
    base = lr_or_schedule if callable(lr_or_schedule) else (lambda step: lr_or_schedule)

    def warmed(step: int) -> float:
        return base(step) * min(1.0, (step + 1) / warmup)

    return warmed


def make_lr_schedule(
    scheduler_config: dict,
    optimizer_config: dict,
    num_iters: int,
    steps_per_epoch: int,
) -> Schedule:
    lr0 = float(optimizer_config["lr"])
    kind = scheduler_config["type"]
    if kind == "target_lr":
        num_epochs = -(-int(num_iters) // steps_per_epoch)
        gamma = (float(scheduler_config["final_lr"]) / lr0) ** (1.0 / num_epochs)

        def schedule(step: int) -> float:
            return lr0 * gamma ** (step // steps_per_epoch)

        return schedule
    if kind == "fixed":
        gamma = float(scheduler_config["gamma"])
        interval = int(scheduler_config["decay_interval"])
        start = int(scheduler_config["decay_start"])

        def schedule(step: int) -> float:
            return lr0 * gamma ** max(0, step // interval - start // interval)

        return schedule
    raise NotImplementedError(f"Unknown scheduler type {kind}")
