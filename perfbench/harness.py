"""The harness: one run of one cell.

``main`` checks for the cards the cell asks for, runs the cell's runner
(set-up, the measured window, with ``--trace 1`` a profiled window, then
the comparison with the reference), reads the cell's metrics by name, and
prints the result line last on standard output, after the compared numbers
and their limits on standard error. It exits non-zero, printing no result,
without the cards, when a module of JAX or of the JAX package was loaded,
or when the program cannot be imported."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from perfbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "atmonr_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclass
class Run:
    """What a runner hands the metric readers."""

    cell: str
    device: object
    setup_s: float = math.nan
    window_s: float = math.nan
    work: dict = field(default_factory=dict)  # counts over the window: steps, rays, points...
    spans: dict = field(default_factory=dict)  # host-clock spans: name -> list of seconds
    counters: dict = field(default_factory=dict)  # the program's launch counters over the window
    peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    trace: object = None  # perfbench.trace.Trace of the profiled window
    traced: dict = field(default_factory=dict)  # work in the profiled window
    checks: dict = field(default_factory=dict)  # compared number -> value
    readings: dict = field(default_factory=dict)  # every reading of the comparison
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    power_limit: str = "not measured"


def card_description(dev) -> tuple[str, str]:
    """(name, power limit) of a card."""
    import torch

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "not measured"
    return name, out or "not measured"


def run_cell(root: Path, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, cell: spec.Cell | None = None, variants: tuple = ()
             ) -> tuple[Run, spec.Cell]:
    """Run the cell's runner on ``device`` and return its record.
    ``variants`` (``perfbench/calibrate.py`` only) also reads the
    lower-precision controls and planted faults against the reference."""
    cell = spec.load_cell(root, cell_name) if cell is None else cell
    run = Run(cell_name, device, config=cell.config, traffic=cell.traffic)
    run.variants = tuple(variants)
    spec.runner(cell.traffic["runner"]).run(run, seed=seed, seconds=seconds, trace=trace, t0=t0)
    return run, cell


def judge(run: Run, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number the
    cell has a limit for was read, is finite and lies within it."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = run.checks.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok and run.failed == 0, checks


def metrics_of(run: Run, entries: list, root: Path) -> dict:
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(run: Run, cell: spec.Cell, trace: bool) -> dict:
    correct, checks = judge(run, cell.limits)
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": getattr(run, "kind", run.device.type), "count": int(cell.entry["chips"]),
              "memory_peak_bytes": int(run.peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics_of(run, cell.per_layer if trace else cell.end_to_end, cell.root),
            "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["power_limit"] = run.power_limit
    line["launches"] = run.counters
    line["checks"] = checks
    return line


def main(argv: list[str], root: str, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root)
    bench = spec.load_benchmark(root)
    cell = spec.load_cell(root, args.workload, bench)

    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    run, cell = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), dev, t0,
                         cell)
    run.kind, run.power_limit = card_description(dev)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    line = result_line(run, cell, bool(args.trace))
    print(f"readings {json.dumps(run.readings)}", file=sys.stderr)
    for name in ("block_s", "block_cpu_s"):
        b = sorted(run.spans.get(name, ()))
        if b:
            print(f"{name} {len(b)} blocks: min {b[0]:.4f} median {b[len(b) // 2]:.4f} "
                  f"max {b[-1]:.4f} sum {sum(b):.3f}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
