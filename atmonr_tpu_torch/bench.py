"""Headline benchmark of the port: Instant-NGP training throughput (rays/s
on one card), the counterpart of the JAX repo's root ``bench.py``.

Times ``Trainer.step`` of ``configs/instant_ngp_tpu_occ13.json`` at full
width (q8 2^13 hash tables with stochastic rounding, 32 occupancy probes
placing 24 fine samples a ray, 32-wide MLPs, clipped AdamW) on a
``make_synthetic_granule(48, 24, 2)`` granule, 8,192 rays a step: the
config's trainer block at a constant lr of 1e-2 and without the progress
scatter (``trainer_config``), a ``Trainer`` of seed 0 (its parameters, draws
and refresh jitter), and one permutation from its ``perm`` stream that the
steps cycle through. The occupancy refresh every ``update_every`` steps is
the Trainer's, inside the timed window.

Timing: one refresh before timing, ``warm_until_steady`` in blocks of 10
steps (at most 400), each block's rate printed as a provisional line, a
provisional window of 50 steps, then the timed window of 250.

    python -m atmonr_tpu_torch.bench

Prints JSON lines on stdout, the final one last:
    {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N, "device": ...}

``vs_baseline`` divides by 1e5 rays/s, BASELINE.md's denominator (an A100
HBM roofline of the reference's step), not a TPU figure. Phase markers go
to stderr.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

REFERENCE_RAYS_PER_S_ESTIMATE = 1.0e5
CONFIG = Path(__file__).resolve().parent.parent / "configs" / "instant_ngp_tpu_occ13.json"
BATCH_SIZE = 8192
GRANULE = {"height": 48, "width": 24, "views_per_band": 2}
LR = 1e-2
WARMUP_BLOCK = 10
MAX_WARMUP_ITERS = 400
PROVISIONAL_ITERS = 50
TIMED_ITERS = 250
SEED = 0  # the Trainer's: parameters, permutation, draws, refresh jitter

_T0 = time.perf_counter()


def _phase(name: str) -> None:
    """Wall-clock phase marker on stderr (stdout carries only the JSON)."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {name}", file=sys.stderr, flush=True)


def emit(rays_per_s: float, device: str, provisional: bool = False,
         source: str | None = None) -> None:
    """One result line on stdout; ``device`` names the card (or "cpu")."""
    line = {
        "metric": "instant_ngp_train_rays_per_s_per_chip",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / REFERENCE_RAYS_PER_S_ESTIMATE, 3),
        "device": device,
    }
    if provisional:
        line["provisional"] = True
    if source:
        line["source"] = source
    print(json.dumps(line), flush=True)


def trainer_config(trainer: dict, batch_size: int) -> dict:
    """The bench's Trainer block: ``trainer`` (a config's) at ``batch_size``
    rays a step and a constant lr of ``LR``, without the progress scatter."""
    return {**trainer, "batch_size": batch_size, "progress": False,
            "optimizer": {**trainer["optimizer"], "lr": LR},
            "scheduler": {"type": "fixed", "gamma": 1.0, "decay_start": 0, "decay_interval": 1}}


def main(*, device: str | torch.device | None = None, batch_size: int = BATCH_SIZE,
         granule: dict | None = None, warmup_block: int = WARMUP_BLOCK,
         max_warmup_iters: int = MAX_WARMUP_ITERS, provisional_iters: int = PROVISIONAL_ITERS,
         timed_iters: int = TIMED_ITERS) -> float:
    """Runs the bench on ``device`` (``cuda`` unless given; raises when there
    is no card) and returns the timed window's rays/s. The keyword arguments
    shrink it for a CPU run."""
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.data.batching import epoch_permutation
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.tools import tool_trainer
    from atmonr_tpu_torch.utils.benchmark import timed_window, warm_until_steady
    from atmonr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    config = load_config(CONFIG)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _phase(f"on {name}")
    dataset = HARP2Dataset(config["dataset"], make_synthetic_granule(**(granule or GRANULE)),
                           device=dev)
    _phase("dataset ready")
    pipe = get_pipeline(config["pipeline"], dataset, device=dev)
    with tool_trainer(trainer_config(config["trainer"], batch_size), dataset, pipe, "bench",
                      SEED) as trainer:
        b = trainer.batch_size
        perm = epoch_permutation(trainer.generators["perm"], trainer.num_rays, b)
        spe = trainer.steps_per_epoch

        def one_iter(step: int) -> torch.Tensor:
            slot = step % spe
            return trainer.step(perm[slot * b : (slot + 1) * b])

        _phase("pipeline + parameters ready")
        pipe.update_aux(generator=trainer.generators["aux"])  # one refresh before timing

        step = warm_until_steady(
            one_iter, float, block=warmup_block, max_iters=max_warmup_iters,
            on_block=lambda n, dt: emit(b * n / dt, name, provisional=True,
                                        source="warmup block"),
        )
        _phase(f"warmup steady at step {step}")
        dt = timed_window(one_iter, float, start_step=step, iters=provisional_iters)
        step += provisional_iters
        emit(b * provisional_iters / dt, name, provisional=True)
        dt = timed_window(one_iter, float, start_step=step, iters=timed_iters)
    _phase("timed window done")
    rays_per_s = b * timed_iters / dt
    emit(rays_per_s, name)
    return rays_per_s


if __name__ == "__main__":
    main()
