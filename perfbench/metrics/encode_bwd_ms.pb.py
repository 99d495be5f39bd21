"""encode_bwd_ms.pb (ms, lower; device trace; layer kernels; moves
setup_s; the pair-bucket train cell): device milliseconds a step of the
operations launched inside the program's ``hash_encode.bwd`` spans: both
grids' table gradients (the position grid's autograd backward of the exact
gather, the surface grid's K2 and its fill). None where the spans do not
count every point of the profiled steps' backwards."""

from perfbench.work_pb import encoded_points


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    if (getattr(run, "span_counts", {}).get("hash_encode.bwd") or 0) < encoded_points(
            run.traced, True):
        return None
    t = run.trace.device_seconds_within("hash_encode.bwd")
    return None if t is None else 1e3 * t / run.traced["steps"]
