"""Scaling benchmark: rays/s of the sharded Instant-NGP train step against
the mesh's size, the counterpart of the JAX repo's ``tools/bench_scaling.py``.

One process per device (torchrun; NCCL on cards, gloo with
``device="cpu"``). For each mesh spec it times
``parallel/train.py::make_ngp_sharded_train_step`` on the flagship config
over a ``synthetic:96x48x2`` granule under weak scaling: 8,192 rays per
data index on cards (512 on the CPU), the occupancy refresh every
``update_every`` steps, ``warm_until_steady`` then a timed window. Every
rank builds every mesh; a rank outside a spec's mesh waits at the world's
barrier. The first rank prints a line a spec.

    torchrun --nproc-per-node N -m atmonr_tpu_torch.tools.bench_scaling [data=4,sample=2 ...]
    # default sweep: data=1 / data=2 / data=4 / data=8, as far as the world reaches

Without torchrun it joins a world of one process (``data=1`` only). One
card takes one rank: NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from atmonr_tpu_torch.tools import repo_path
from atmonr_tpu_torch.utils.benchmark import timed_window, warm_until_steady

CONFIG = repo_path("configs/instant_ngp_tpu_occ13.json")


def run(spec: str, base_batch: int, device: torch.device, iters: int = 50,
        granule: dict | None = None, warm_block: int | None = None,
        max_warm_iters: int | None = None) -> float | None:
    """Rays/s of the whole mesh of ``spec`` (None on a rank outside it)."""
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.data.batching import epoch_permutation
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.parallel.mesh import (
        in_mesh, is_first_rank, make_mesh_from_spec, mesh_shape, rank_device,
    )
    from atmonr_tpu_torch.parallel.sharding import replicate, shard_rays
    from atmonr_tpu_torch.parallel.train import (
        make_ngp_sharded_train_step, sample_sharded_draws,
    )

    mesh = make_mesh_from_spec(spec)
    if not in_mesh(mesh):
        dist.barrier()
        return None
    dev = rank_device(device)
    n_data = mesh_shape(mesh)["data"]
    config = load_config(CONFIG)
    granule = make_synthetic_granule(**(granule or {"height": 96, "width": 48,
                                                    "views_per_band": 2}))
    ds = HARP2Dataset(config["dataset"], granule, device=dev)
    pipe = get_pipeline(config["pipeline"], ds, device=dev)
    opt = pipe.make_optimizer(config["trainer"]["optimizer"], 1e-2)
    replicate(pipe, mesh)
    rays = shard_rays(ds.rays(dev), mesh)
    n = rays["origin"].shape[0]  # this data index's rows
    batch = min(base_batch * n_data, n * n_data)  # weak scaling: constant rays per index
    rank_batch = batch // n_data
    step = make_ngp_sharded_train_step(pipe, opt, mesh, rank_batch)
    aux_every = pipe.occ_cfg.update_every if pipe.occ_cfg else 0
    gens = {k: torch.Generator(device=dev).manual_seed(s)
            for k, s in (("perm", 1), ("draws", 0), ("aux", 2))}
    perm = epoch_permutation(gens["perm"], n, rank_batch)
    spe = max(1, n // rank_batch)
    if aux_every:  # the refresh's first call outside any timed window
        pipe.update_aux(generator=gens["aux"])

    def one_iter(s):
        draws = sample_sharded_draws(pipe, rank_batch, gens["draws"])
        loss = step(rays, perm, s % spe, draws)
        if aux_every and (s + 1) % aux_every == 0:
            pipe.update_aux(generator=gens["aux"])
        return loss.detach()

    on_card = dev.type == "cuda"
    s0 = warm_until_steady(
        one_iter, float,
        block=warm_block or (25 if on_card else 3),
        max_iters=max_warm_iters or (1200 if on_card else 6),
    )
    dt = timed_window(one_iter, float, start_step=s0, iters=iters)
    rps = batch * iters / dt
    if is_first_rank(mesh):
        print(f"[mesh {spec}] batch={batch} {iters} iters in {dt:.2f}s: "
              f"{rps:,.0f} rays/s total, {rps / n_data:,.0f} rays/s per data shard",
              flush=True)
    dist.barrier()
    return rps


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         **run_kwargs) -> dict[str, float | None]:
    """Joins the process group (torchrun's, else a world of one; a group
    already joined is kept), runs each spec and returns this rank's rays/s
    by spec. ``device`` is ``cuda`` unless given; ``run_kwargs`` go to
    ``run`` (``iters``, ``granule``, ``base_batch``, the warm-up's)."""
    from atmonr_tpu_torch.parallel.mesh import initialize_distributed, rank_device
    from atmonr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    created = not dist.is_initialized()
    initialize_distributed(dev)
    try:
        world = dist.get_world_size()
        specs = sys.argv[1:] if argv is None else argv
        if not specs:
            specs = [f"data={d},sample=1" for d in (1, 2, 4, 8) if d <= world]
        on_card = dev.type == "cuda"
        kind = torch.cuda.get_device_name(rank_device(dev)) if on_card else "cpu"
        if dist.get_rank() == 0:
            print(f"devices: {world} x {kind}", flush=True)
        base_batch = run_kwargs.pop("base_batch", 8192 if on_card else 512)
        return {spec: run(spec, base_batch, dev, **run_kwargs) for spec in specs}
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
