"""A/B: train Instant-NGP with the q8 (int8-table) forward, then score
PSNR/SSIM with the flagship's forward on the SAME trained float32 master
weights, the deployment recipe where only the training loop is quantized:
the counterpart of the JAX repo's ``tools/ab_q8_train_fp_eval.py``.

It is ``ab_q8_twophase.run_two_phase`` with the switch after the last
step: every step through the training config, the score through the
evaluation config.

    python -m atmonr_tpu_torch.tools.ab_q8_train_fp_eval [hard] [train_config] [eval_config]
"""

from __future__ import annotations

import sys

import torch

from atmonr_tpu_torch.tools.ab_importance import BATCH_SIZE
from atmonr_tpu_torch.tools.ab_q8_twophase import FP, Q8, run_two_phase


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         num_iters: int = 3000, granule: dict | None = None,
         batch_size: int = BATCH_SIZE) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    n_blobs = 40 if "hard" in argv else 1
    if "hard" in argv:
        argv.remove("hard")
    train_path = argv[0] if argv else Q8
    eval_path = argv[1] if len(argv) > 1 else FP
    r = run_two_phase(train_path, eval_path, num_iters, num_iters, n_blobs, device=device,
                      granule=granule, batch_size=batch_size)
    print(
        f"[train={train_path.split('/')[-1]} eval={eval_path.split('/')[-1]}] "
        f"{r['iters']} iters in {r['seconds']:.1f}s ({r['rays_per_s']:.0f} rays/s) "
        f"PSNR={r['psnr']:.3f} SSIM={r['ssim']:.4f} on {r['device']}",
        flush=True,
    )
    return r


if __name__ == "__main__":
    main()
