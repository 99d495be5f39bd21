"""Headline benchmark of the port: Instant-NGP training throughput (rays/s
on one card), the counterpart of the JAX repo's root ``bench.py``.

Times a hand-rolled train step of ``configs/instant_ngp_tpu_occ13.json``
at full width (q8 2^13 hash tables with stochastic rounding, 32 occupancy
probes placing 24 fine samples a ray, 32-wide MLPs, clipped AdamW at a
constant lr of 1e-2) on a ``make_synthetic_granule(48, 24, 2)`` granule,
8,192 rays a step, parameters from seed 0: the batch gather from the
device-resident rays, forward, loss, backward (kernel K2), the optimizer
step, and the occupancy refresh every ``update_every`` steps on the host's
cadence (inside the timed window). There is no Trainer here: no progress
scatter, no epoch metrics, no restart check, so its rays/s is above the
Trainer's steady step.

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
# the seeds of the JAX bench's keys: parameters 0, permutation 1, draws 2,
# refresh jitter 3
SEEDS = {"params": 0, "perm": 1, "draws": 2, "aux": 3}

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


def make_train_step(pipe, optimizer, rays: dict, perm: torch.Tensor, batch_size: int,
                    draws_gen: torch.Generator | None = None,
                    aux_gen: torch.Generator | None = None):
    """The bench's step as ``one_iter(step, draws=None, aux_jitter=None)``:
    the batch of ``perm``'s slot ``step % steps_per_epoch``, forward with the
    draws of ``draws_gen`` (or ``draws``), loss, backward, optimizer step;
    then, every ``update_every`` steps, the occupancy refresh from
    ``aux_gen`` (or ``aux_jitter``). Returns the loss (detached, on the
    device)."""
    from atmonr_tpu_torch.data.batching import batch_at_step

    every = pipe.occ_cfg.update_every if pipe.occ_cfg is not None else 0
    steps_per_epoch = perm.shape[0] // batch_size

    def one_iter(step: int, draws=None, aux_jitter=None) -> torch.Tensor:
        batch = batch_at_step(rays, perm, step % steps_per_epoch, batch_size)
        if draws is None:
            draws = pipe.make_draws(batch_size, draws_gen)
        optimizer.zero_grad()
        loss = pipe.compute_loss(batch, pipe(batch, draws=draws))
        loss.backward()
        optimizer.step()
        if every and (step + 1) % every == 0:
            if aux_jitter is None:
                pipe.update_aux(generator=aux_gen)
            else:
                pipe.update_aux(jitter=aux_jitter)
        return loss.detach()

    return one_iter


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
    from atmonr_tpu_torch.utils.benchmark import timed_window, warm_until_steady
    from atmonr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    config = load_config(CONFIG)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _phase(f"on {name}")
    dataset = HARP2Dataset(config["dataset"], make_synthetic_granule(**(granule or GRANULE)),
                           device=dev)
    _phase("dataset ready")
    pipe = get_pipeline(config["pipeline"], dataset, device=dev,
                        generator=torch.Generator().manual_seed(SEEDS["params"]))
    optimizer = pipe.make_optimizer(config["trainer"]["optimizer"], LR)
    rays = dataset.rays(dev)
    gens = {k: torch.Generator(device=dev).manual_seed(s) for k, s in SEEDS.items()
            if k != "params"}
    perm = epoch_permutation(gens["perm"], len(dataset), batch_size)
    one_iter = make_train_step(pipe, optimizer, rays, perm, batch_size, gens["draws"],
                               gens["aux"])
    _phase("pipeline + parameters ready")
    pipe.update_aux(generator=gens["aux"])  # one refresh before timing

    step = warm_until_steady(
        one_iter, float, block=warmup_block, max_iters=max_warmup_iters,
        on_block=lambda n, dt: emit(batch_size * n / dt, name, provisional=True,
                                    source="warmup block"),
    )
    _phase(f"warmup steady at step {step}")
    dt = timed_window(one_iter, float, start_step=step, iters=provisional_iters)
    step += provisional_iters
    emit(batch_size * provisional_iters / dt, name, provisional=True)
    dt = timed_window(one_iter, float, start_step=step, iters=timed_iters)
    _phase("timed window done")
    rays_per_s = batch_size * timed_iters / dt
    emit(rays_per_s, name)
    return rays_per_s


if __name__ == "__main__":
    main()
