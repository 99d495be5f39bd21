"""Step-time breakdown at the REFERENCE capacity (2^21 tables, 1,024
samples a ray, ``configs/instant_ngp.json``) on one card: the counterpart
of the JAX repo's ``tools/diag_ref_capacity.py``.

Times each stage of the train step alone, at the whole batch (no
micro-batches), so that work at 2^21 lands where the milliseconds are:

    encode_fwd      the position hash encode's forward alone (kernel K1)
    pipeline_fwd    the stochastic forward and the loss
    encode_bwd      the hash-table gradient of a cotangent of ones (K1, K2)
    full_grad       forward, loss and backward
    train_step      ``Trainer.step`` on the config's trainer block, at the
                    whole batch

``encode_fwd``, ``full_grad`` and ``train_step`` are ``profile_step``'s
stages. Each is timed by the host's clock over ``iters`` calls between two
syncs, after one warm call.

    python -m atmonr_tpu_torch.tools.diag_ref_capacity [batch=8192] [iters=5]
        [config=configs/instant_ngp.json] [stage=all|step]
"""

from __future__ import annotations

import sys

import torch

from atmonr_tpu_torch.tools import repo_path
from atmonr_tpu_torch.tools.profile_step import stage_fns
from atmonr_tpu_torch.utils.timing import wall_s


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         granule: dict | None = None) -> dict[str, float]:
    """Prints a line a stage and returns the seconds of each; ``device`` is
    ``cuda`` unless given."""
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.data.batching import gather_batch
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.models.hash_grid import hash_encode
    from atmonr_tpu_torch.tools import batches, tool_trainer
    from atmonr_tpu_torch.utils.device import describe_device, resolve_device

    batch_size, iters = 8192, 5
    config_path = "configs/instant_ngp.json"
    stages = "all"
    for a in sys.argv[1:] if argv is None else argv:
        k, _, v = a.partition("=")
        if k == "batch":
            batch_size = int(v)
        elif k == "iters":
            iters = int(v)
        elif k == "config":
            config_path = v
        elif k == "stage":  # "step": the full train step only
            stages = v

    dev = resolve_device(device)
    cfg = load_config(repo_path(config_path))
    ds = HARP2Dataset(cfg["dataset"], make_synthetic_granule(
        **(granule or {"height": 96, "width": 48, "views_per_band": 2})), device=dev)
    pipe = get_pipeline(cfg["pipeline"], ds, device=dev)
    batch_size = min(batch_size, ds.num_rays)
    occ = pipe.occ_cfg
    n_samples = int(occ.n_fine if occ else cfg["pipeline"]["num_samples_per_ray"])
    m = batch_size * n_samples
    cfg3 = pipe.pos_cfg
    print(f"reference capacity: batch={batch_size}, samples={n_samples}, "
          f"levels={cfg3.n_levels}, table=2^"
          f"{cfg['pipeline']['instant_ngp']['encoding']['log2_hashmap_size']}, "
          f"points/iter={m / 1e6:.1f}M, on {describe_device(dev)}", flush=True)

    x = torch.rand((m, cfg3.n_dims), generator=torch.Generator(device=dev).manual_seed(2),
                   device=dev)
    draws = pipe.make_draws(batch_size, torch.Generator(device=dev).manual_seed(3))
    rows = m * cfg3.n_levels * (1 << cfg3.n_dims)
    times = {}

    def timeit(name, fn):
        times[name] = wall_s(fn, dev, iters, 1)
        print(f"{name:14s} {times[name] * 1e3:9.1f} ms/iter", flush=True)

    with tool_trainer(cfg["trainer"], ds, pipe, "diag_ref_capacity", batch_size=batch_size,
                      micro_batch_size=0) as tr:
        idx = next(batches(tr))
        fns = stage_fns(tr, idx, draws, x)
        if stages == "all":
            timeit("encode_fwd", fns["encode_fwd"])
            print(f"  -> {rows / times['encode_fwd'] / 1e6:.0f} M corner-gathers/s", flush=True)
            batch = gather_batch(tr.rays, idx)

            def pipeline_fwd():
                with torch.no_grad():
                    return pipe.compute_loss(batch, pipe(batch, draws=draws))

            timeit("pipeline_fwd", pipeline_fwd)
            table = pipe.pos_table
            g = torch.ones((m, cfg3.n_output_dims), device=dev)

            def encode_bwd():
                return torch.autograd.grad(hash_encode(table, x, cfg3), table, g)

            timeit("encode_bwd", encode_bwd)
            print(f"  -> {rows / times['encode_bwd'] / 1e6:.0f} M contributions/s", flush=True)
            timeit("full_grad", fns["grad"])
        timeit("train_step", fns["step"])
    print(f"  -> {batch_size / times['train_step']:.0f} rays/s", flush=True)
    return times


if __name__ == "__main__":
    main()
