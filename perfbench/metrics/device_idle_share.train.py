"""device_idle_share.train (%, lower; device trace; layer device; moves
setup_s): one minus the device's busy seconds a step over the
window's seconds a step. Busy is the union of the kernel, copy and memset
intervals of the profiled steps (their device time, which the profiler
leaves as it is); a step's seconds come from the untraced window, since the
profiler slows the host that sets this step's pace."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    busy = run.trace.busy_s() / run.traced["steps"]
    return 100.0 * (1.0 - busy / (run.window_s / run.work["steps"]))
