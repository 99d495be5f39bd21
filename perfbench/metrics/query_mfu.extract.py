"""query_mfu.extract (%, higher; host clock; layer whole query; moves
extract_points_per_s): the density branch's FLOPs of the window's
extractions (hash-encode interpolation and MLP products, forward only;
``perfbench/work.py``) over the window's seconds, grid builds included, as
a share of the dense bf16 peak (989 TFLOP/s). The untraced window: the
profiler slows the host-bound query."""

from perfbench.roofline import PEAK_BF16_FLOPS


def read(run):
    if run.device.type != "cuda":  # the peak is the card's
        return None
    return 100.0 * run.work["flops"] / run.window_s / PEAK_BF16_FLOPS
