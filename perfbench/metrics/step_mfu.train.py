"""step_mfu.train (%, higher; host clock; layer whole step; moves
setup_s): the model FLOPs of the window's steps (MLP products
forward and backward, hash-encode interpolation and its gradient, the
refreshes' forward; ``perfbench/work.py``) over the window's seconds, as
a share of the dense bf16 peak (989 TFLOP/s: the MLPs compute in
bfloat16). The untraced window: the profiler slows the host-bound step."""

from perfbench.roofline import PEAK_BF16_FLOPS


def read(run):
    if run.device.type != "cuda":  # the peak is the card's
        return None
    return 100.0 * run.work["flops"] / run.window_s / PEAK_BF16_FLOPS
