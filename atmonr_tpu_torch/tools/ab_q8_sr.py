"""Seed-swept A/B: does stochastic rounding fix q8's quality floor? The
counterpart of the JAX repo's ``tools/ab_q8_sr.py``.

Cells: the flagship config, q8 with deterministic rounding (``_q8``) and q8
with stochastic rounding (``_q8sr``), each through ``ab_importance.run`` at
a fixed iteration count, so that within a seed the three share their
parameter, draw and permutation streams. Single-run PSNR at a few thousand
iterations spreads by several dB across seeds, so each cell is a mean over
seeds.

    python -m atmonr_tpu_torch.tools.ab_q8_sr [hard] [seeds=0,1,2] [iters=3000] [name ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from atmonr_tpu_torch.tools.ab_importance import BATCH_SIZE, run

VARIANTS = {
    "bf16": "configs/instant_ngp_tpu_occ13.json",
    "q8det": "configs/instant_ngp_tpu_occ13_q8.json",
    "q8sr": "configs/instant_ngp_tpu_occ13_q8sr.json",
}


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         granule: dict | None = None, batch_size: int = BATCH_SIZE) -> dict[str, list[float]]:
    """Seed-major sweep (an interrupted one still covers cells); returns
    each variant's PSNR per seed."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n_blobs = 1
    if "hard" in argv:
        argv.remove("hard")
        n_blobs = 40
    seeds = [0, 1, 2]
    iters = 3000
    for a in list(argv):
        if a.startswith("seeds="):
            seeds = [int(s) for s in a.split("=", 1)[1].split(",")]
            argv.remove(a)
        elif a.startswith("iters="):
            iters = int(a.split("=", 1)[1])
            argv.remove(a)
    names = argv or list(VARIANTS)

    table: dict[str, list[float]] = {}
    for seed in seeds:
        for name in names:
            r = run(name, VARIANTS[name], iters, n_blobs=n_blobs, seed=seed, device=device,
                    granule=granule, batch_size=batch_size)
            table.setdefault(name, []).append(r["psnr"])
    scene = "hard" if n_blobs > 1 else "smooth"
    print(f"== {scene} scene, {iters} iters, seeds {seeds} ==", flush=True)
    for name, vals in table.items():
        print(
            f"{name}: mean PSNR {np.mean(vals):.2f} +- {np.std(vals):.2f} "
            f"({', '.join(f'{v:.2f}' for v in vals)})",
            flush=True,
        )
    return table


if __name__ == "__main__":
    main()
