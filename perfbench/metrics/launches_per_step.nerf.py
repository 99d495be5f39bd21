"""launches_per_step.nerf (launches/step, lower; device trace; layer
trainer; moves setup_s): CUDA kernel events in the profiled window over
the steps in it."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return run.trace.launches() / run.traced["steps"]
