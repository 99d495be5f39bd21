"""encode_fwd_roofline.extract (%, higher; device trace; layer kernels;
moves extract_points_per_s): the least time of the query's position
encodes in the profiled extractions (one a batch;
``perfbench/roofline.py``) over the device time of K1 and K1p."""

from perfbench.work import least_encode_seconds

PATTERN = r"hash_gather_|quantize_kernel"


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    t = run.trace.kernel_seconds(PATTERN)
    return 100.0 * least_encode_seconds(run.traced["encode_fwd"], False) / t if t else None
