"""Device timing of a call on the current CUDA device."""

from __future__ import annotations

import statistics

import torch


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of per-call CUDA event times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, per_graph: int = 20, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``per_graph`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events; the median replay
    over ``per_graph``. Replay leaves out the host's per-call launch work,
    which ``median_ms`` includes."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)
