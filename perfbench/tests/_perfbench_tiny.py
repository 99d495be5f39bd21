"""Tiny CPU versions of the benchmark's cells for the tests: the same
runners, configurations and comparison, at a granule and batch the CPU
runs in seconds.

On the CPU the reference's float64 geodesy (PyTorch's CPU math) and the
program's host library can round a ray's origin differently in the last
float32 bit; the scene's normalization box then differs by an eighth of a
metre, and the float32 point preprocessor turns that into gaps of up to
~1e-3 in the loss and ~1e-2 in a leaf's change. On the card the two agree
(PERF.md): the committed limits are set there. ``CPU_TOLERANCE`` bounds
the unbroken program's readings here; the refreshed grid is computed by
both from the program's own parameters, and agrees to rounding."""

from __future__ import annotations

import time
from pathlib import Path

import torch

from perfbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]
CPU_TOLERANCE = {"loss_gap": 5e-3, "grad_gap": 1e-2, "update_gap": 3e-2, "occ_gap": 1e-4,
                 "grid_gap_m": 1e-4, "sigma_gap": 3e-2}


def tiny_cell(name: str, root: Path = ROOT) -> spec.Cell:
    cell = spec.load_cell(root, name)
    tr = cell.traffic
    if tr["runner"] == "train":
        tr["granule"] = {"kind": "real_schema", "height": 16, "width": 12}
        cell.config["trainer"]["batch_size"] = 256
        tr.update(warmup_max_steps=16, trace_steps=16)
    else:
        tr["granule"] = {"kind": "swath", "height": 32, "width": 16, "views_per_band": 2}
        tr.update(grid_args={"alt_step": 1000.0}, batch_size=512, warmup_extractions=1,
                  trace_extractions=1)
    return cell


def tiny_run(name: str, seed: int = 2**33 + 17, trace: bool = False, root: Path = ROOT,
             variants: tuple = ()):
    """One run of the tiny cell on the CPU: (Run, Cell)."""
    cell = tiny_cell(name, root)
    return harness.run_cell(root, name, seed, 0.5, trace, torch.device("cpu"),
                            time.perf_counter(), cell, variants)
