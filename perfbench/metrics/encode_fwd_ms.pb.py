"""encode_fwd_ms.pb (ms, lower; device trace; layer kernels; moves
setup_s; the pair-bucket train cell): device milliseconds a step of the
operations launched inside the program's ``hash_encode.fwd`` spans: both
grids' encodes (the position grid's exact gather, the surface grid's K1)
with their table preparations, and the occupancy refreshes' encodes.
None where the spans do not count every encoded point of the profiled
steps (a program whose exact gather opens no span)."""

from perfbench.work_pb import encoded_points


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    if (getattr(run, "span_counts", {}).get("hash_encode.fwd") or 0) < encoded_points(
            run.traced, False):
        return None
    t = run.trace.device_seconds_within("hash_encode.fwd")
    return None if t is None else 1e3 * t / run.traced["steps"]
