"""The work of the NeRF cells, counted from the configuration's shapes:
the points through each AtmoNeRF and the FLOPs of their products (the
GEMMs), which the utilization and roofline metrics divide by measured
time.

A train step of ``B`` rays runs ``B N_c`` points through the coarse MLP
and ``B (N_c + N_f)`` through the fine one, each layer's (out, in) weight
once a point: ``2 out in`` FLOPs forward and twice that backward (the
input's and the weight's gradients). Biases, activations, encodings and
compositing are not products and are not counted.

The peak is the H100 SXM's dense TF32 tensor-core rate (NVIDIA's data
sheet, 700 W): the products are float32 with TF32 off, which the SIMT
units compute at 67 TFLOP/s, but a float32-accurate product on the tensor
cores (split TF32 or split bf16) can pass that, and a share of a peak
never reads above 100%."""

from __future__ import annotations

from perfbench import roofline
from perfbench.reference.nerf import param_shapes

PEAK_TF32_FLOPS = 494.7e12


def _layers(pipeline_cfg: dict, model: str) -> list[tuple[int, int]]:
    return [v for k, v in param_shapes(pipeline_cfg).items()
            if k.startswith(model + ".") and k.endswith(".weight")]


def train_work(pipeline_cfg: dict, batch: int, steps: int) -> dict:
    """``steps`` train steps of ``batch`` rays: their rays and points and
    the AtmoNeRF products' FLOPs, forward (``fwd_flops``) and forward with
    backward (``flops``)."""
    n_c = int(pipeline_cfg["sampler"]["N_c"])
    n_f = int(pipeline_cfg["sampler"]["N_f"])
    coarse, fine = batch * n_c, batch * (n_c + n_f)
    fwd = (roofline.mlp_flops(coarse, _layers(pipeline_cfg, "coarse"), False)
           + roofline.mlp_flops(fine, _layers(pipeline_cfg, "fine"), False))
    return {"steps": steps, "rays": steps * batch, "points": steps * (coarse + fine),
            "fwd_flops": steps * fwd, "flops": 3 * steps * fwd}
