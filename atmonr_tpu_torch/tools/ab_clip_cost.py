"""Interleaved A/B of the ``clip_global_norm`` guard's throughput cost: the
counterpart of the JAX repo's ``tools/ab_clip_cost.py``.

One process times the flagship's step (``Trainer.step`` on the config's
trainer block, the occupancy refresh every ``update_every`` steps) with and
without the global-norm clip, in turns (noclip, clip, noclip, clip, noclip,
clip), so that warm-up and drift cannot pass for the guard's cost. Each arm
is a Trainer of its own, from the same seed, on a 48x24-pixel synthetic
granule; each window ends in a sync.

    python -m atmonr_tpu_torch.tools.ab_clip_cost [iters=250]
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from atmonr_tpu_torch.tools import repo_path

BATCH_SIZE = 8192
WARMUP = 30
CONFIG = "configs/instant_ngp_tpu_occ13.json"


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         granule: dict | None = None, batch_size: int = BATCH_SIZE,
         warmup: int = WARMUP) -> dict:
    """Prints each window and the guard's cost; returns each arm's rays/s
    per window and the cost (1 - clip / noclip, negative when clip is
    faster). ``device`` is ``cuda`` unless given."""
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.tools import batches, tool_trainer
    from atmonr_tpu_torch.utils.device import describe_device, resolve_device
    from atmonr_tpu_torch.utils.timing import fence

    iters = 250
    for a in sys.argv[1:] if argv is None else argv:
        k, _, v = a.partition("=")
        if k == "iters":
            iters = int(v)

    dev = resolve_device(device)
    config = load_config(repo_path(CONFIG))
    clip_cfg = config["trainer"]["optimizer"]
    noclip_cfg = {k: v for k, v in clip_cfg.items() if k != "clip_global_norm"}
    ds = HARP2Dataset(config["dataset"], make_synthetic_granule(
        **(granule or {"height": 48, "width": 24, "views_per_band": 2})), device=dev)

    arms = {}
    with contextlib.ExitStack() as stack:
        for name, opt_cfg in (("clip", clip_cfg), ("noclip", noclip_cfg)):
            pipe = get_pipeline(config["pipeline"], ds, device=dev)
            tr = stack.enter_context(tool_trainer(config["trainer"], ds, pipe, name,
                                                  batch_size=batch_size, optimizer=opt_cfg))
            arms[name] = {"trainer": tr, "rows": batches(tr), "rates": []}

        def window(name: str, n: int, timed: bool) -> None:
            arm = arms[name]
            tr = arm["trainer"]
            fence(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                loss = tr.step(next(arm["rows"]))
            float(loss)  # sync
            dt = time.perf_counter() - t0
            if timed:
                b = tr.batch_size
                arm["rates"].append(b * n / dt)
                print(f"{name:7s} {dt / n * 1e3:7.2f} ms/iter {b * n / dt / 1e3:8.1f}k rays/s",
                      flush=True)

        for name in arms:  # warm both arms before any timed window
            window(name, warmup, False)
        for name in ("noclip", "clip", "noclip", "clip", "noclip", "clip"):
            window(name, iters, True)

    r = {n: np.asarray(arms[n]["rates"]) for n in ("clip", "noclip")}
    cost = 1.0 - np.mean(r["clip"]) / np.mean(r["noclip"])
    print(
        f"\nclip   {np.mean(r['clip']) / 1e3:8.1f}k ± {np.std(r['clip']) / 1e3:5.1f}k rays/s"
        f"\nnoclip {np.mean(r['noclip']) / 1e3:8.1f}k ± {np.std(r['noclip']) / 1e3:5.1f}k rays/s"
        f"\nguard cost: {cost * 100:+.2f}% (negative = clip faster; n=3 interleaved) on "
        f"{describe_device(dev)}",
        flush=True,
    )
    return {"clip": r["clip"].tolist(), "noclip": r["noclip"].tolist(), "cost": float(cost)}


if __name__ == "__main__":
    main()
