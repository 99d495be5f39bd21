"""Readings for the comparison's limits, on the card: for each seed one run
of a cell (set-up, a short window, the comparison), with the
lower-precision controls and the planted faults read against the same
reference inputs in the same process. The benchmark's own runs never run
this.

    python3 perfbench/calibrate.py --workload <cell> --seeds <a,b,...> --seconds <s>
        --variants table:q4,half_batch --out <file.jsonl>

One JSON line a seed: the program's readings, and each variant's."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--variants", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    variants = tuple(v for v in args.variants.split(",") if v)
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            run, cell = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, dev, t0,
                                         variants=variants)
            row = {"workload": args.workload, "seed": seed, "readings": run.readings,
                   "setup_s": run.setup_s, "work": run.work, "window_s": run.window_s,
                   "peak_mb": run.peak_bytes / 1e6, "launches": run.counters, "check_s": run.spans.get("check_s"),
                   "wall_s": time.perf_counter() - t0}
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
