"""A/B: two-phase Instant-NGP training, the q8 (int8-table) forward for the
first fraction of the iterations, then the flagship's forward for the rest:
the counterpart of the JAX repo's ``tools/ab_q8_twophase.py``.

If 8-bit training noise only perturbs the end of convergence, a short
tail in the other forward should recover its PSNR at ~q8 speed. Each
phase is a ``Trainer`` of its config, stepped as ``ab_importance.run``
steps one (``Trainer.step``, the first step before the clock, a new
permutation every epoch; no restart check), and the score is the
deterministic forward of the second config on the same float32 master
weights.

    python -m atmonr_tpu_torch.tools.ab_q8_twophase [hard] [switch_frac=0.8] [seed=0]
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from atmonr_tpu_torch.tools import repo_path
from atmonr_tpu_torch.tools.ab_importance import BATCH_SIZE, GRANULE, evaluate

Q8 = "configs/instant_ngp_tpu_occ13_q8.json"
FP = "configs/instant_ngp_tpu_occ13.json"


def run_two_phase(first_path: str, second_path: str, num_iters: int, switch_at: int,
                  n_blobs: int = 1, seed: int = 0, *,
                  device: str | torch.device | None = None, granule: dict | None = None,
                  batch_size: int = BATCH_SIZE) -> dict:
    """Train steps ``0 .. switch_at - 1`` through a Trainer of
    ``first_path``'s pipeline and the rest through one of ``second_path``'s,
    the second taking over the first's parameters, occupancy grid,
    optimizer state, random streams and step count at the switch; then
    score ``second_path``'s deterministic forward over every ray. The two
    configs must differ only in their forward (their parameters have one
    layout); the trainer block is the first's. Seeds as
    ``ab_importance.run``'s. Returns ``iters``, ``seconds``, ``rays_per_s``,
    ``psnr``, ``ssim`` and ``device``."""
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.tools import batches, tool_trainer
    from atmonr_tpu_torch.utils.device import describe_device, resolve_device

    dev = resolve_device(device)
    cfgs = [load_config(repo_path(p)) for p in (first_path, second_path)]
    ds = HARP2Dataset(cfgs[0]["dataset"],
                      make_synthetic_granule(**(granule or GRANULE), n_blobs=n_blobs), device=dev)
    with contextlib.ExitStack() as stack:
        first, second = (
            stack.enter_context(tool_trainer(cfgs[0]["trainer"], ds,
                                             get_pipeline(c["pipeline"], ds, device=dev),
                                             name, seed, batch_size=batch_size,
                                             num_iters=num_iters))
            for name, c in zip(("first", "second"), cfgs))

        def switch() -> None:
            p0, p1 = first.pipeline, second.pipeline
            p1.load_params(dict(p0.named_parameters()))
            if p0.occ_cfg is not None:
                p1.occ.copy_(p0.occ)
            second.optimizer.load_state_dict(first.optimizer.state_dict())
            second.generators, second.iter_count = first.generators, first.iter_count

        rows = batches(first)  # the streams go on in the second
        cur, t0 = first, None
        while cur.iter_count < num_iters:
            if cur is first and cur.iter_count >= switch_at:
                switch()
                cur = second
            loss = cur.step(next(rows))
            if t0 is None:
                float(loss)  # the kernels' first build stays outside the clock
                t0 = time.perf_counter()
        float(loss)
        dt = time.perf_counter() - t0
        if cur is first:
            switch()
        b, scorer = second.batch_size, second.pipeline
    del first, second, cur  # the optimizers' moments are dead weight in the eval
    m = evaluate(scorer, ds, b)
    return {"iters": num_iters, "seconds": round(dt, 2),
            "rays_per_s": round(num_iters * b / dt, 1), "psnr": float(m["PSNR_mean"]),
            "ssim": float(m["SSIM_mean"]), "device": describe_device(dev)}


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         num_iters: int = 3000, granule: dict | None = None,
         batch_size: int = BATCH_SIZE) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    n_blobs = 40 if "hard" in argv else 1
    if "hard" in argv:
        argv.remove("hard")
    switch_frac = float(argv[0]) if argv else 0.8
    seed = int(argv[1]) if len(argv) > 1 else 0
    r = run_two_phase(Q8, FP, num_iters, int(num_iters * switch_frac), n_blobs, seed,
                      device=device, granule=granule, batch_size=batch_size)
    print(
        f"[two-phase switch@{switch_frac:.0%} seed={seed}] {r['iters']} iters in "
        f"{r['seconds']:.1f}s ({r['rays_per_s']:.0f} rays/s) PSNR={r['psnr']:.3f} "
        f"SSIM={r['ssim']:.4f} on {r['device']}",
        flush=True,
    )
    return r


if __name__ == "__main__":
    main()
