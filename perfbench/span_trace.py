"""The device time under the program's spans, from the profiled window's
Chrome trace.

While a torch profiler runs and the program records spans
(``atmonr_tpu_torch.utils.spans``), each span is a ``record_function``
range: a ``user_annotation`` event on the thread that opened it. A device
operation (kernel, copy, memset) belongs to the spans open on the thread
that launched it when it was launched: the runtime or driver call with the
operation's correlation id. ``profiled`` is ``trace.profiled`` with its
trace kept as a ``SpanTrace``, which ``trace.Trace``'s readers read as
before. Where the program opens no span, no operation lies under one."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager

from perfbench.trace import Trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class SpanTrace(Trace):
    def __init__(self, events: list, window_s: float):
        super().__init__(events, window_s)
        spans = defaultdict(list)
        for e in events:
            cat = e.get("cat")
            if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                self.launch_ts.setdefault(e["args"]["correlation"], (e.get("tid"), e["ts"]))
            elif cat == "user_annotation" and e.get("ph") == "X":
                spans[e.get("tid")].append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
        self.spans = {tid: sorted(v) for tid, v in spans.items()}
        self.span_starts = {tid: [s[0] for s in v] for tid, v in self.spans.items()}

    def span_names(self) -> set:
        return {s[2] for v in self.spans.values() for s in v}

    def open_spans(self, correlation) -> list[str]:
        """The spans open around an operation's launch, innermost first."""
        tid, ts = self.launch_ts.get(correlation, (None, None))
        spans = self.spans.get(tid, [])
        i = bisect.bisect_right(self.span_starts.get(tid, []), ts) if spans else 0
        return [s[2] for s in reversed(spans[:i]) if s[1] >= ts]

    def device_seconds_within(self, name: str) -> float | None:
        """Device seconds of the operations launched inside spans ``name``
        (at any depth); None where no such span was recorded."""
        if name not in self.span_names():
            return None
        return sum(e - s for s, e, _, corr, _ in self.device
                   if name in self.open_spans(corr)) * 1e-6

    def device_seconds_by_span(self) -> dict[str, float]:
        """Device seconds by the innermost span around each operation's
        launch; "no span" for operations launched outside every span."""
        out = defaultdict(float)
        for s, e, _, corr, _ in self.device:
            inner = self.open_spans(corr)
            out[inner[0] if inner else "no span"] += (e - s) * 1e-6
        return dict(out)


@contextmanager
def profiled(device, out: dict):
    """Profile the body; ``out["trace"]`` is its ``SpanTrace`` afterwards.
    The window is timed on the host between two device synchronisations."""
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
    out["trace"] = SpanTrace(events, window)
