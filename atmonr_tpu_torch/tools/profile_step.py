"""Break an Instant-NGP train step into timed pieces on one card: the
counterpart of the JAX repo's ``tools/profile_step.py``.

At B = 8,192 rays of a ``make_synthetic_granule(48, 24, 2)`` granule, with
parameters from seed 0, it times the position hash encode's forward alone
(on M = B x samples uniform points), the encode's forward and backward, the
pipeline forward, loss and gradient, and the full train step (gradient and
clipped AdamW update), each as warm calls then a window of calls with a
sync at both ends; the backward and the rest fall out by subtraction.

    python -m atmonr_tpu_torch.tools.profile_step [CONFIG]   # default configs/instant_ngp_tpu.json
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from atmonr_tpu_torch.utils.timing import wall_s

REPO = Path(__file__).resolve().parent.parent.parent
DEFAULT_CONFIG = "configs/instant_ngp_tpu.json"


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         batch: int = 8192, granule: dict | None = None, iters: int = 10,
         warmup: int = 2) -> dict[str, float]:
    """Prints a line a stage and returns the seconds of each; ``device`` is
    ``cuda`` unless given."""
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.models.hash_grid import hash_encode
    from atmonr_tpu_torch.utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    cfg_path = argv[0] if argv else DEFAULT_CONFIG
    dev = resolve_device(device)
    config = load_config(REPO / cfg_path if not Path(cfg_path).is_absolute() else cfg_path)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"config: {cfg_path} on {name}")
    granule = make_synthetic_granule(**(granule or {"height": 48, "width": 24,
                                                    "views_per_band": 2}))
    dataset = HARP2Dataset(config["dataset"], granule, device=dev)
    pipe = get_pipeline(config["pipeline"], dataset, device=dev,
                        generator=torch.Generator().manual_seed(0))
    opt = pipe.make_optimizer(config["trainer"]["optimizer"], 1e-2)
    b = min(batch, len(dataset))
    rays = {k: v[:b] for k, v in dataset.rays(dev).items()}
    draws = pipe.make_draws(b, torch.Generator(device=dev).manual_seed(2))

    occ = pipe.occ_cfg  # the grid as built: every cell occupied
    n_samples = occ.n_fine if occ else int(config["pipeline"]["num_samples_per_ray"])
    m = b * n_samples
    cfg3 = pipe.pos_cfg
    times = {}

    def show(key, label, t):
        times[key] = t
        print(f"{label:32s}{t * 1e3:8.1f} ms", flush=True)

    # 1. the hash encode's forward alone (M uniform points)
    x = torch.rand((m, cfg3.n_dims), generator=torch.Generator(device=dev).manual_seed(3),
                   device=dev)
    table = pipe.pos_table

    def enc_fwd():
        with torch.no_grad():
            return hash_encode(table, x, cfg3)

    show("encode_fwd", f"hash-encode fwd ({m} pts):", wall_s(enc_fwd, dev, iters, warmup))

    # 2. its forward and backward
    def enc_grad():
        return torch.autograd.grad(torch.sum(hash_encode(table, x, cfg3) ** 2), table)

    show("encode_fwd_bwd", "hash-encode fwd+bwd:", wall_s(enc_grad, dev, iters, warmup))

    # 3. the pipeline forward
    def fwd():
        with torch.no_grad():
            return pipe(rays, draws=draws)

    show("forward", "pipeline forward:", wall_s(fwd, dev, iters, warmup))

    # 4. loss and gradient
    def grad():
        pipe.zero_grad()
        pipe.compute_loss(rays, pipe(rays, draws=draws)).backward()

    show("grad", "pipeline fwd+bwd (grad):", wall_s(grad, dev, iters, warmup))

    # 5. the full train step: gradient and optimizer update
    def step():
        opt.zero_grad()
        pipe.compute_loss(rays, pipe(rays, draws=draws)).backward()
        opt.step()

    show("step", "full train step:", wall_s(step, dev, iters, warmup))
    show("backward", "backward (grad - forward):", times["grad"] - times["forward"])
    show("update", "optimizer (step - grad):", times["step"] - times["grad"])
    print(f"{f'rays/s at B={b}:':32s}{b / times['step']:8.0f}", flush=True)
    return times


if __name__ == "__main__":
    main()
