"""mlp_fwd_roofline.nerf (%, higher; device trace; layer pipeline; moves
setup_s): the least time of the profiled steps' AtmoNeRF forward products
(their FLOPs at the dense TF32 peak, 494.7 TFLOP/s; ``perfbench/
work_nerf.py``) over the device seconds of every operation launched inside
the program's ``nerf.mlp`` spans (``perfbench/span_trace.py``): counted by
span, not by kernel name, so that a fused MLP kernel is held to the same
work. None where the program opens no such span."""

from perfbench.work_nerf import PEAK_TF32_FLOPS


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    t = run.trace.device_seconds_within("nerf.mlp")
    return 100.0 * run.traced["fwd_flops"] / PEAK_TF32_FLOPS / t if t else None
