"""Benchmark the production Trainer path against the bare-step headline: the
counterpart of the JAX repo's ``tools/bench_trainer.py``.

``atmonr_tpu_torch.bench`` times a hand-rolled step; the Trainer's step
adds the progress scatter (each ray's prediction in its own band), running
loss bookkeeping and the generator's yield, and each epoch's end adds the
host sync of the metrics (PSNR/SSIM and the RGB image) and an asynchronous
checkpoint. This tool drives ``Trainer.iterate`` on the flagship config
over a ``synthetic:384x96x2`` granule (by default): three epochs of
warm-up, then ``epochs`` epochs, each with a window strictly inside it,
and reports:

- ``in_epoch_rays_per_s``: steps strictly inside an epoch (the number to
  set beside the bench's bare step);
- ``overall_rays_per_s``: with the epoch-boundary sync, at this granule's
  steps per epoch;
- ``epoch_sync_s``: the measured cost of an epoch's end;
- ``real_scale_rays_per_s``: the overall rate projected to the real
  granule's epoch (14.6 M rays / 8,192 = 1,787 steps), where the sync
  amortizes away.

The fence is a device sync.

    python -m atmonr_tpu_torch.tools.bench_trainer [height=384] [width=96] [epochs=8]
        [config=configs/instant_ngp_tpu_occ13.json] [pf=N] [progress=0|1]
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from atmonr_tpu_torch.tools import repo_path
from atmonr_tpu_torch.utils.timing import fence

REAL_GRANULE_RAYS = 14_600_000


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         warm_epochs: int = 3, batch_size: int | None = None) -> dict:
    """Prints the report's JSON line and returns it; ``device`` is ``cuda``
    unless given, ``batch_size`` the config's unless given. Needs at least
    3 steps an epoch (a window inside each)."""
    from atmonr_tpu_torch import Trainer, get_pipeline, load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.utils.device import resolve_device

    height, width, epochs = 384, 96, 8
    config_path = "configs/instant_ngp_tpu_occ13.json"
    pf = None  # print_frequency override (isolates the logging's cost)
    progress = None  # progress=0 drops the progress scatter and the epoch metrics
    for a in sys.argv[1:] if argv is None else argv:
        k, _, v = a.partition("=")
        if k == "height":
            height = int(v)
        elif k == "width":
            width = int(v)
        elif k == "epochs":
            epochs = int(v)
        elif k == "config":
            config_path = v
        elif k == "pf":
            pf = int(v)
        elif k == "progress":
            progress = bool(int(v))

    dev = resolve_device(device)
    t0 = time.perf_counter()
    cfg = load_config(repo_path(config_path))
    granule = make_synthetic_granule(height=height, width=width, views_per_band=2)
    ds = HARP2Dataset(cfg["dataset"], granule, device=dev)
    pipe = get_pipeline(cfg["pipeline"], ds, device=dev)
    tcfg = dict(cfg["trainer"], num_iters=10**9)
    if batch_size is not None:
        tcfg["batch_size"] = batch_size
    if pf is not None:
        tcfg["print_frequency"] = pf
    if progress is not None:
        tcfg["progress"] = progress
    with tempfile.TemporaryDirectory(prefix="bench_trainer_") as tmp:
        trainer = Trainer(tcfg, ds, pipe, "bench_trainer", data_root=tmp, device=dev)
        b = trainer.batch_size
        spe = trainer.steps_per_epoch
        if spe < 3:
            raise ValueError(f"{spe} steps an epoch: a window inside an epoch needs 3 or more")
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"[setup +{time.perf_counter() - t0:.1f}s] {ds.num_rays} rays, batch {b}, "
              f"{spe} steps/epoch, on {name}", file=sys.stderr, flush=True)

        gen = trainer.iterate(Path(tmp) / "out")
        # warm-up: the kernels' first launches and the allocator's pools
        t0 = time.perf_counter()
        warm = warm_epochs * spe
        for _ in range(warm):
            next(gen)
        fence(dev)
        print(f"[warmup +{time.perf_counter() - t0:.1f}s] {warm} steps done", file=sys.stderr,
              flush=True)

        in_epoch_s = 0.0
        in_epoch_iters = 0
        t_all = time.perf_counter()
        for _ in range(epochs):
            # at an epoch boundary (warm is a multiple of spe)
            next(gen)  # the epoch's first step (absorbs the previous end)
            fence(dev)
            t1 = time.perf_counter()
            for _ in range(spe - 2):
                next(gen)
            fence(dev)
            in_epoch_s += time.perf_counter() - t1
            in_epoch_iters += spe - 2
            next(gen)  # the epoch's last step; its yield precedes the epoch's end
        fence(dev)
        overall_s = time.perf_counter() - t_all
        gen.close()
        trainer.checkpointer.wait()  # the last save in flight, before the directory goes

    in_epoch = b * in_epoch_iters / in_epoch_s
    overall = b * epochs * spe / overall_s
    # an epoch end's cost: what the in-epoch windows left out beyond their
    # own steps' share
    step_s = in_epoch_s / in_epoch_iters
    epoch_sync_s = max(0.0, overall_s / epochs - spe * step_s)
    real_spe = REAL_GRANULE_RAYS // b
    real_scale = b / (step_s + epoch_sync_s / real_spe)

    report = {
        "config": config_path,
        "progress": bool(trainer.progress),
        "num_rays": int(ds.num_rays),
        "batch_size": int(b),
        "steps_per_epoch": int(spe),
        "epochs_timed": epochs,
        "in_epoch_rays_per_s": round(in_epoch, 1),
        "overall_rays_per_s": round(overall, 1),
        "epoch_sync_s": round(epoch_sync_s, 3),
        "real_scale_steps_per_epoch": int(real_spe),
        "real_scale_rays_per_s": round(real_scale, 1),
        "device": name,
    }
    print()  # the Trainer's loss line ends without one
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
