"""encode_fwd_roofline.train (%, higher; device trace; layer kernels; moves
setup_s): the least time of every hash-encode forward in the
profiled window (the position and surface encodes of each step, the
position encode of each occupancy refresh; ``perfbench/roofline.py``) over
the device time of the kernels that compute them: the gather K1 and the
table quantizer K1p."""

from perfbench.work import least_encode_seconds

PATTERN = r"hash_gather_|quantize_kernel"


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    t = run.trace.kernel_seconds(PATTERN)
    return 100.0 * least_encode_seconds(run.traced["encode_fwd"], False) / t if t else None
