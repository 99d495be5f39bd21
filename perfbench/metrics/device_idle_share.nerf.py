"""device_idle_share.nerf (%, lower; device trace; layer device; moves
setup_s): one minus the device's busy seconds a step over the window's
seconds a step. Busy is the union of the kernel, copy and memset intervals
of the profiled steps; a step's seconds come from the untraced window."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    busy = run.trace.busy_s() / run.traced["steps"]
    return 100.0 * (1.0 - busy / (run.window_s / run.work["steps"]))
