"""The profiled window: ``torch.profiler`` over CPU and CUDA activity,
read back from its Chrome trace.

Device activity is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
event; busy time is the union of their intervals. An idle gap between two
device intervals is put down to the host operation that launched the work
ending it: the innermost ``cpu_op`` around the launch's runtime call."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device = sorted(((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"],
                               e.get("args", {}).get("correlation"), e["cat"])
                              for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"))
        self.kernels = [d for d in self.device if d[4] == "kernel"]
        self.launch_ts = {}  # correlation -> (tid, ts) of the runtime call
        ops = defaultdict(list)
        for e in events:
            cat = e.get("cat")
            if cat == "cuda_runtime" and "correlation" in e.get("args", {}):
                self.launch_ts[e["args"]["correlation"]] = (e.get("tid"), e["ts"])
            elif cat == "cpu_op" and e.get("ph") == "X":
                ops[e.get("tid")].append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
        self.ops = {tid: sorted(v) for tid, v in ops.items()}
        self.op_starts = {tid: [o[0] for o in v] for tid, v in self.ops.items()}

    def launches(self) -> int:
        return len(self.kernels)

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for s, e, name, _, _ in self.kernels if rx.search(name)) * 1e-6

    def kernel_runs(self) -> list:
        """(name, start, end) of every kernel in device order."""
        return [(name, s, e) for s, e, name, _, _ in self.kernels]

    def _intervals(self):
        merged = []
        for s, e, *_ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._intervals()) * 1e-6

    def _host_op(self, correlation) -> str:
        tid, ts = self.launch_ts.get(correlation, (None, None))
        ops = self.ops.get(tid, [])
        i = bisect.bisect_right(self.op_starts.get(tid, []), ts) if ops else 0
        while i > 0:  # the latest-starting operation around the launch is the innermost
            i -= 1
            if ops[i][1] >= ts:
                return ops[i][2]
        return "no host operation"

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for s, e, name, _, _ in self.device:
            by_name[name[:120]] += (e - s) * 1e-6
        starts = {}
        for s, e, name, corr, _ in self.device:
            starts.setdefault(s, corr)
        gaps = defaultdict(float)
        merged = self._intervals()
        for (s0, e0), (s1, e1) in zip(merged, merged[1:]):
            gaps[self._host_op(starts.get(s1))[:120]] += (s1 - e0) * 1e-6
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": order(by_name), "idle_gaps": order(gaps)}


@contextmanager
def profiled(device, out: dict):
    """Profile the body; ``out["trace"]`` is its ``Trace`` afterwards. The
    window is timed on the host between two device synchronisations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with profile(activities=acts) as prof:
        sync()
        t = time.perf_counter()
        yield
        sync()
        window = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out["trace"] = Trace(events, window)
