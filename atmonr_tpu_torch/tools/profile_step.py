"""Break an Instant-NGP train step into timed pieces on one card: the
counterpart of the JAX repo's ``tools/profile_step.py``.

At B = 8,192 rays of a ``make_synthetic_granule(48, 24, 2)`` granule, with
parameters from seed 0, it times the position hash encode's forward alone
(on M = B x samples uniform points), the encode's forward and backward, the
pipeline forward, loss and gradient, and the full train step
(``Trainer.step`` on the config's trainer block: the batch gather, the
gradient, the clipped AdamW update, the progress scatter and the occupancy
refresh on its cadence), each as warm calls then a window of calls with a
sync at both ends; the backward and the rest fall out by subtraction.

    python -m atmonr_tpu_torch.tools.profile_step [CONFIG]   # default configs/instant_ngp_tpu.json
"""

from __future__ import annotations

import sys

import torch

from atmonr_tpu_torch.tools import repo_path
from atmonr_tpu_torch.utils.timing import wall_s

DEFAULT_CONFIG = "configs/instant_ngp_tpu.json"


def stage_fns(trainer, idx: torch.Tensor, draws: dict, x: torch.Tensor) -> dict:
    """The timed stages of a train step as callables: ``encode_fwd`` (the
    position hash encode's forward alone on the points ``x``),
    ``encode_fwd_bwd`` (its forward and table gradient), ``forward`` (the
    pipeline forward of the rows ``idx`` with ``draws``), ``grad`` (forward,
    loss and backward) and ``step`` (``trainer.step`` of those rows, with
    the Trainer's own draws)."""
    from atmonr_tpu_torch.data.batching import gather_batch
    from atmonr_tpu_torch.models.hash_grid import hash_encode

    pipe = trainer.pipeline
    table, cfg3 = pipe.pos_table, pipe.pos_cfg
    rays = gather_batch(trainer.rays, idx)

    def encode_fwd():
        with torch.no_grad():
            return hash_encode(table, x, cfg3)

    def encode_fwd_bwd():
        return torch.autograd.grad(torch.sum(hash_encode(table, x, cfg3) ** 2), table)

    def forward():
        with torch.no_grad():
            return pipe(rays, draws=draws)

    def grad():
        pipe.zero_grad()
        pipe.compute_loss(rays, pipe(rays, draws=draws)).backward()

    def step():
        return trainer.step(idx)

    return {"encode_fwd": encode_fwd, "encode_fwd_bwd": encode_fwd_bwd, "forward": forward,
            "grad": grad, "step": step}


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         batch: int = 8192, granule: dict | None = None, iters: int = 10,
         warmup: int = 2) -> dict[str, float]:
    """Prints a line a stage and returns the seconds of each; ``device`` is
    ``cuda`` unless given."""
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.tools import tool_trainer
    from atmonr_tpu_torch.utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    cfg_path = argv[0] if argv else DEFAULT_CONFIG
    dev = resolve_device(device)
    config = load_config(repo_path(cfg_path))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"config: {cfg_path} on {name}")
    granule = make_synthetic_granule(**(granule or {"height": 48, "width": 24,
                                                    "views_per_band": 2}))
    dataset = HARP2Dataset(config["dataset"], granule, device=dev)
    pipe = get_pipeline(config["pipeline"], dataset, device=dev)
    b = min(batch, len(dataset))
    draws = pipe.make_draws(b, torch.Generator(device=dev).manual_seed(2))

    occ = pipe.occ_cfg  # the grid as built: every cell occupied
    n_samples = occ.n_fine if occ else int(config["pipeline"]["num_samples_per_ray"])
    m = b * n_samples
    cfg3 = pipe.pos_cfg
    times = {}

    def show(key, label, t):
        times[key] = t
        print(f"{label:32s}{t * 1e3:8.1f} ms", flush=True)

    x = torch.rand((m, cfg3.n_dims), generator=torch.Generator(device=dev).manual_seed(3),
                   device=dev)
    with tool_trainer(config["trainer"], dataset, pipe, "profile_step", batch_size=b) as tr:
        fns = stage_fns(tr, torch.arange(b, device=dev), draws, x)
        for key, label in (("encode_fwd", f"hash-encode fwd ({m} pts):"),
                           ("encode_fwd_bwd", "hash-encode fwd+bwd:"),
                           ("forward", "pipeline forward:"),
                           ("grad", "pipeline fwd+bwd (grad):"),
                           ("step", "full train step:")):
            show(key, label, wall_s(fns[key], dev, iters, warmup))
    show("backward", "backward (grad - forward):", times["grad"] - times["forward"])
    show("update", "optimizer (step - grad):", times["step"] - times["grad"])
    print(f"{f'rays/s at B={b}:':32s}{b / times['step']:8.0f}", flush=True)
    return times


if __name__ == "__main__":
    main()
