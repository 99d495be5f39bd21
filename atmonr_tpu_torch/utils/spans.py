"""Spans: named intervals of the program's host work, to find which phase
of a train step or an extraction holds the host.

``span(name)`` marks a phase where its work happens: ``Trainer.step`` and
its parts, the hash encode's forward and backward, the dataset build, the
extraction's grid and query and the query's parts. Outside ``recording()``
it returns one shared object that does nothing: it reads no clock and
allocates nothing. Inside, each span is kept as a ``Span`` record: its
name, id and parent's id, the train step it belongs to, its thread
(``threading.get_ident``), its wall interval (``perf_counter_ns``) and
``count``, the work it covers (rays, points). Opening and closing a span
makes no system call. A span opened with ``cpu=True`` also keeps the CPU
time its thread spent in it (``thread_time_ns``, a system call); wall less
CPU is the time the thread was off a CPU: waiting on the card or on
another thread, or preempted. Only long, rare spans ask for it: on the
H100 machines the benchmark runs on, a system call inside a train step
can cost a millisecond, and the thread CPU clock counts in 10 ms steps
(``PERF.md``).

Parents are kept per thread. A span opened on a thread that has none of
its own open, such as autograd's device thread, which runs the backward of
CUDA work while the thread that called ``backward()`` waits, takes as its
parent the innermost open span of the thread that opened the current step
(``trainer.backward`` there), and that step's id.

While a torch profiler is active, a recorded span is also a
``torch.profiler.record_function`` range, so the profiler's trace carries
the phases over the kernels (``Trainer.iterate(profile=True)``). Outside a
profiler it is not: such a range costs over ten microseconds even with no
profiler running.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Iterable, Iterator

import torch


class _NoSpan:
    """What ``span`` returns outside ``recording()``: one shared object
    that ignores ``count``."""

    __slots__ = ()
    count = property(lambda self: None, lambda self, value: None)

    def __enter__(self) -> _NoSpan:
        return self

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Recorder:
    """The state of one ``recording()`` block."""

    def __init__(self) -> None:
        self.records: list[Span] = []
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.open: dict[int, list[Span]] = {}  # thread -> its open spans, innermost last
        self.step: Span | None = None  # the open span that opened a step


# the recording block in progress, if any
_active: _Recorder | None = None


class Span:
    """One recorded span; ``count`` may be set while it is open."""

    __slots__ = ("name", "id", "parent", "step", "thread", "start_ns", "end_ns", "cpu_ns",
                 "count", "_recorder", "_range")

    def __init__(self, recorder: _Recorder, name: str, count: int | None, step: int | None,
                 cpu: bool):
        self._recorder = recorder
        self.name = name
        self.count = count
        self.step = step
        self.cpu_ns = 0 if cpu else None
        self._range = None

    def __enter__(self) -> Span:
        rec, tid = self._recorder, threading.get_ident()
        with rec.lock:
            own = rec.open.setdefault(tid, [])
            outer = own[-1] if own else None
            if outer is None and rec.step is not None:
                home = rec.open.get(rec.step.thread)
                outer = home[-1] if home else None
            self.id = next(rec.ids)
            self.parent = None if outer is None else outer.id
            if self.step is None:
                self.step = None if outer is None else outer.step
            else:
                rec.step = self
            self.thread = tid
            own.append(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.cpu_ns is not None:
            self.cpu_ns = time.thread_time_ns()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.cpu_ns is not None:
            self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        rec = self._recorder
        with rec.lock:
            rec.open[self.thread].pop()
            if rec.step is self:
                rec.step = None
            rec.records.append(self)
        self._recorder = None


def span(name: str, count: int | None = None, step: int | None = None,
         cpu: bool = False) -> Span | _NoSpan:
    """A span named ``name`` covering ``count`` units of work; ``step``
    opens train step ``step``, which the spans inside it take as theirs;
    ``cpu`` reads its thread's CPU time too. Recorded only inside
    ``recording()``."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return Span(rec, name, count, step, cpu)


@contextmanager
def recording() -> Iterator[list[Span]]:
    """Record the spans of the block, of every thread. Yields the list of
    records, to which each span is added as it closes."""
    global _active
    if _active is not None:
        raise RuntimeError("spans are already being recorded")
    _active = _Recorder()
    try:
        yield _active.records
    finally:
        _active = None


def _covered_ns(intervals: list[tuple[int, int]], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) inside the union of ``intervals``."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def summary(records: Iterable[Span]) -> dict[str, dict]:
    """The records by name: ``calls``; ``wall_s``; ``self_s``, wall less
    what its children cover; ``off_cpu_s``, wall less its thread's CPU
    time; ``count``; each summed (``off_cpu_s`` and ``count`` None where no
    span of the name has one)."""
    records = list(records)
    children = defaultdict(list)
    for r in records:
        if r.parent is not None:
            children[r.parent].append((r.start_ns, r.end_ns))
    out: dict[str, dict] = {}
    for r in records:
        s = out.setdefault(r.name, {"calls": 0, "wall_s": 0.0, "self_s": 0.0,
                                    "off_cpu_s": None, "count": None})
        wall = r.end_ns - r.start_ns
        s["calls"] += 1
        s["wall_s"] += wall * 1e-9
        s["self_s"] += (wall - _covered_ns(children[r.id], r.start_ns, r.end_ns)) * 1e-9
        if r.cpu_ns is not None:
            s["off_cpu_s"] = (s["off_cpu_s"] or 0.0) + max(wall - r.cpu_ns, 0) * 1e-9
        if r.count is not None:
            s["count"] = (s["count"] or 0) + r.count
    return out
