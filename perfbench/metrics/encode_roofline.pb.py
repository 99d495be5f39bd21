"""encode_roofline.pb (%, higher; device trace; layer kernels; moves
setup_s; the pair-bucket train cell): the least time of every hash encode
and table gradient of the profiled steps (both grids, the refreshes'
encodes; ``perfbench/work_pb.py``, the same count whatever implements the
encode) over the device seconds of the operations launched inside the
program's ``hash_encode.fwd`` and ``hash_encode.bwd`` spans. None where
the spans do not count every encoded point, forward and backward."""

from perfbench.work_pb import encoded_points, least_seconds


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    counts = getattr(run, "span_counts", {})
    for name, backward in (("hash_encode.fwd", False), ("hash_encode.bwd", True)):
        if (counts.get(name) or 0) < encoded_points(run.traced, backward):
            return None
    t = sum(run.trace.device_seconds_within(name) or 0.0
            for name in ("hash_encode.fwd", "hash_encode.bwd"))
    return 100.0 * least_seconds(run.config["pipeline"], run.traced) / t if t else None
