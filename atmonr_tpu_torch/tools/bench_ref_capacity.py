"""Train-step throughput at the REFERENCE working point, through the
Trainer's step (gradient micro-batches included): the counterpart of the
JAX repo's ``tools/bench_ref_capacity.py``.

``configs/instant_ngp.json`` is the reference's own working point: 2^21
hash tables, 1,024 uniform samples a ray, 8,192 rays a step (8.4 M point
evaluations a step), in micro-batches of ``micro_batch_size`` rays whose
gradients make the full batch's. This times that step as a user runs it,
on a 96x48-pixel synthetic granule: the first step (the kernels' builds),
``warmup`` more, then ``iters`` between two syncs.

    python -m atmonr_tpu_torch.tools.bench_ref_capacity [config=...] [iters=3] [warmup=2]
"""

from __future__ import annotations

import sys
import tempfile
import time

import torch

from atmonr_tpu_torch.tools import repo_path
from atmonr_tpu_torch.utils.timing import fence


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         granule: dict | None = None) -> dict:
    """Prints the JAX tool's lines and returns the steady step's ms and
    rays/s; ``device`` is ``cuda`` unless given."""
    from atmonr_tpu_torch import Trainer, get_pipeline, load_config
    from atmonr_tpu_torch.data.batching import epoch_permutation
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.utils.device import describe_device, resolve_device

    config_path = "configs/instant_ngp.json"
    iters, warmup = 3, 2
    for a in sys.argv[1:] if argv is None else argv:
        k, _, v = a.partition("=")
        if k == "config":
            config_path = v
        elif k == "iters":
            iters = int(v)
        elif k == "warmup":
            warmup = int(v)

    dev = resolve_device(device)
    cfg = load_config(repo_path(config_path))
    ds = HARP2Dataset(cfg["dataset"], make_synthetic_granule(
        **(granule or {"height": 96, "width": 48, "views_per_band": 2})), device=dev)
    pipe = get_pipeline(cfg["pipeline"], ds, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg["trainer"], ds, pipe, "refcap", data_root=tmp, device=dev)
        b = trainer.batch_size
        print(f"config={config_path} batch={b} micro={trainer.micro_batch} "
              f"samples={cfg['pipeline'].get('num_samples_per_ray')} "
              f"occ={'occupancy' in cfg['pipeline']} on {describe_device(dev)}", flush=True)
        perm = epoch_permutation(torch.Generator(device=dev).manual_seed(0), trainer.num_rays, b)
        spe = trainer.steps_per_epoch

        def step(i):
            j = i % spe
            return trainer.step(perm[j * b:(j + 1) * b])

        t0 = time.perf_counter()
        loss = step(0)
        print(f"first step (the kernels' builds): {time.perf_counter() - t0:.1f}s "
              f"loss={float(loss):.5f}", flush=True)
        for i in range(1, warmup):
            loss = step(i)
        fence(dev)
        t0 = time.perf_counter()
        for j in range(iters):
            loss = step(warmup + j)
        loss = float(loss)
        fence(dev)
        dt = (time.perf_counter() - t0) / iters
    print(f"steady step: {dt * 1e3:.0f} ms  {b / dt:.0f} rays/s  loss={loss:.5f}", flush=True)
    return {"step_ms": dt * 1e3, "rays_per_s": b / dt, "loss": loss,
            "device": describe_device(dev)}


if __name__ == "__main__":
    main()
