"""Seed-swept quality matrix at MATCHED WALL-CLOCK: the counterpart of the
JAX repo's ``tools/quality_matrix.py``.

Seeds x variants x scenes, each cell trained by ``ab_importance.run`` for
the same wall-clock budget (the kernels' first build excluded) and scored
by deterministic PSNR/SSIM. Results stream to a JSONL, each row with the
device it ran on (resumable: a cell already there, keyed by name, scene,
seed and budget, is skipped), and the mean +- std table prints at the end.

    python -m atmonr_tpu_torch.tools.quality_matrix [budget=60] [seeds=0,1,2] [out=...]
        [variants=a,b,...]   # subset of VARIANTS
        [scenes=smooth,hard] # subset of SCENES

The default ``out`` is ``results/quality_matrix.jsonl`` under the repo root
(gitignored): the TPU's records under ``docs/`` are not appended to.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from atmonr_tpu_torch.tools import REPO
from atmonr_tpu_torch.tools.ab_importance import BATCH_SIZE, run

VARIANTS = {
    "uniform128": "configs/instant_ngp_tpu.json",
    "occ15_64p32f": "configs/instant_ngp_tpu_occ.json",
    # the flagship config (guarded occ13 with q8sr tables); the bf16-table
    # and unguarded arms of its A/Bs are occ13_bf16 and occ13_noclip
    "occ13_32p24f": "configs/instant_ngp_tpu_occ13.json",
    "occ13_bf16": "configs/instant_ngp_tpu_occ13_bf16.json",
    # flagship + softplus density activation (collapse guard A/B)
    "occ13_sp": "configs/instant_ngp_tpu_occ13_sp.json",
    # flagship + quiet surface-head init (collapse guard A/B)
    "occ13_qh": "configs/instant_ngp_tpu_occ13_qh.json",
    # flagship + restart-on-plateau
    "occ13_rs": "configs/instant_ngp_tpu_occ13_rs.json",
    "occ13_noclip": "configs/instant_ngp_tpu_occ13_noclip.json",
    "occ13_q8": "configs/instant_ngp_tpu_occ13_q8.json",
    "occ13_q8sr": "configs/instant_ngp_tpu_occ13_q8sr.json",
    # the reference table capacity (2^21) with the occupancy sampler
    "occ21": "configs/instant_ngp_occ21.json",
    # occ21 + pair-bucket hashed-level storage
    "occ21_pb": "configs/instant_ngp_occ21_pb.json",
}
SCENES = {"smooth": 1, "hard": 40}
MAX_ITERS = 200_000  # the wall-clock budget is the real stop
OUT = REPO / "results" / "quality_matrix.jsonl"


def summary(rows: list[dict], names, groups, title: str) -> None:
    """Print mean +- std of PSNR and SSIM for each name in each group (a
    group: a label and a test on a row)."""
    print(title)
    for label, keep in groups:
        if label:
            print(f"-- {label} --")
        for name in names:
            cells = [r for r in rows if r["name"] == name and keep(r)]
            if not cells:
                continue
            p = [r["psnr"] for r in cells]
            s = [r["ssim"] for r in cells]
            it = [r["iters"] for r in cells]
            print(
                f"{name:14s} PSNR {np.mean(p):6.2f} +- {np.std(p):4.2f}  "
                f"SSIM {np.mean(s):.4f} +- {np.std(s):.4f}  "
                f"(~{np.mean(it):.0f} iters/cell, n={len(p)})",
                flush=True,
            )


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         max_iters: int = MAX_ITERS, granule: dict | None = None,
         batch_size: int = BATCH_SIZE) -> list[dict]:
    """Runs the cells not yet in ``out`` on ``device`` (``cuda`` unless
    given), variant-major, and returns every row of ``out`` at this budget
    for the chosen variants and scenes."""
    from atmonr_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)  # before any file is touched
    argv = sys.argv[1:] if argv is None else argv
    budget = 60.0
    seeds = [0, 1, 2]
    out_path = OUT
    names = list(VARIANTS)
    scenes = dict(SCENES)
    for a in argv:
        k, _, v = a.partition("=")
        if k == "budget":
            budget = float(v)
        elif k == "seeds":
            seeds = [int(s) for s in v.split(",")]
        elif k == "out":
            out_path = Path(v)
        elif k == "variants":
            names = v.split(",")
        elif k == "scenes":
            scenes = {s: SCENES[s] for s in v.split(",")}

    done = set()
    if out_path.exists():
        for line in out_path.read_text().splitlines():
            r = json.loads(line)
            # budget is part of the cell identity: one jsonl may carry
            # several matched-wall-clock tiers
            done.add((r["name"], r["scene"], r["seed"], r.get("budget_s")))
    out_path.parent.mkdir(parents=True, exist_ok=True)

    with open(out_path, "a") as f:
        for name in names:
            for scene, n_blobs in scenes.items():
                for seed in seeds:
                    if (name, scene, seed, budget) in done:
                        continue
                    r = run(name, VARIANTS[name], max_iters, n_blobs=n_blobs, seed=seed,
                            seconds=budget, device=device, granule=granule,
                            batch_size=batch_size)
                    r["scene"] = scene
                    r["budget_s"] = budget
                    f.write(json.dumps(r) + "\n")
                    f.flush()

    rows = [json.loads(ln) for ln in out_path.read_text().splitlines()]
    rows = [r for r in rows if r.get("budget_s") == budget and r["name"] in names
            and r["scene"] in scenes]
    summary(rows, names, [(s, lambda r, s=s: r["scene"] == s) for s in scenes],
            f"\n== matched wall-clock {budget:.0f}s/cell, seeds {seeds} ==")
    return rows


if __name__ == "__main__":
    main()
