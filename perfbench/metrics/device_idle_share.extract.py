"""device_idle_share.extract (%, lower; device trace; layer device; moves
extract_points_per_s): one minus the device's busy seconds an extraction
over the window's seconds an extraction. Busy is the union of the kernel,
copy and memset intervals of the profiled extractions; an extraction's
seconds come from the untraced window, since the profiler slows the host
that sets the pace."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    busy = run.trace.busy_s() / run.traced["extractions"]
    return 100.0 * (1.0 - busy / (run.window_s / run.work["extractions"]))
