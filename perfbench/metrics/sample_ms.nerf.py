"""sample_ms.nerf (ms, lower; device trace; layer pipeline; moves
setup_s): device milliseconds a step of the operations launched inside the
program's ``pipeline.sample`` spans: the stratified coarse depths and the
fine depths' inverse CDF (cumsum, searchsorted, gathers, the merge's
sort). None where the program opens no such span."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    t = run.trace.device_seconds_within("pipeline.sample")
    return None if t is None else 1e3 * t / run.traced["steps"]
