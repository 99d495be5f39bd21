"""step_mfu.nerf (%, higher; host clock; layer whole step; moves setup_s):
the AtmoNeRF products' FLOPs of the window's steps, forward and backward
(``perfbench/work_nerf.py``: 3.777 TFLOP a step at the published widths),
over the window's seconds, as a share of the dense TF32 tensor-core peak
(494.7 TFLOP/s). The products are float32 with TF32 off, whose SIMT peak is
67 TFLOP/s; the TF32 peak is the one a float32-accurate product on the
tensor cores (split TF32 or split bf16) cannot pass, so the share stays
under 100% whichever way the program computes them."""

from perfbench.work_nerf import PEAK_TF32_FLOPS


def read(run):
    if run.device.type != "cuda":  # the peak is the card's
        return None
    return 100.0 * run.work["flops"] / run.window_s / PEAK_TF32_FLOPS
