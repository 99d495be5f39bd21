"""The port's counterpart of the root ``__graft_entry__.py``: a forward step
with its example arguments, and a dry run of every multi-device mode.

- ``entry(device=None)`` returns ``(forward_step, (pipeline, batch))``:
  ``forward_step(pipeline, batch)`` is the deterministic Instant-NGP forward
  plus ``compute_loss`` on 64 rays of the 12x8-pixel synthetic granule, and
  returns ``(loss, color_map_fine)``. The parameters are the JAX entry's
  (``init_params(PRNGKey(0))``, drawn by ``convert.jax_ngp_init``). On a
  card the tiny config's ``auto`` mode runs the bf16 gather kernel (K1).
- ``dryrun_multichip(n, device=None)`` runs the JAX dry run's three modes
  on ``n`` ranks, one process each, and prints one ``dryrun_multichip OK:``
  line for each:

  1. ``make_ngp_sharded_train_step`` on a (data = n/2, sample = 2) mesh
     (sample 1 for an odd n) with the occupancy grid: a step, a refresh, a
     step, and a finite loss;
  2. NeRF through ``Trainer.shard`` on data = n, 2 iterations;
  3. ``partition_devices(2)`` over the ranks and ``train_granules`` over two
     granule groups, each a data mesh of its ranks, 2 iterations each.

  The ranks are gloo processes on the CPU (``device="cpu"``) and NCCL
  processes on the cards, rank r on card r (one rank on a machine with one
  card). They meet through a file store in a temporary directory, with no
  network port.

    python -c "from atmonr_tpu_torch import graft_entry as g; g.dryrun_multichip(4, device='cpu')"
    python -c "import torch; from atmonr_tpu_torch import graft_entry as g; g.dryrun_multichip(torch.cuda.device_count())"
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

DATASET_CONFIG = {
    "type": "HARP2",
    "max_abs_view_angle": 45.0,
    "ray_origin_height": 20000,
    "bands_to_keep": [0, 1, 2, 3],
    "rgb_mode": "nadir",
}
ENTRY_RAYS = 64


def _tiny_ngp_config(num_samples: int = 32, occupancy: bool = False) -> dict:
    cfg = {
        "type": "InstantNGP",
        "include_height": False,
        "point_preprocessor": "horizontal",
        "num_bands": 4,
        "multi_band_extinction": False,
        "num_samples_per_ray": num_samples,
        "alt_compress_factor": 8,
        "loss": "mse_plus_hdr",
        "instant_ngp": {
            "ema_decay": None,
            "encoding": {
                "otype": "HashGrid",
                "n_levels": 8,
                "n_features_per_level": 2,
                "log2_hashmap_size": 14,
                "base_resolution": 16,
                "per_level_scale": 1.3819,
            },
            "network": {"n_neurons": 32, "n_hidden_layers": 1},
            "dir_encoding": {
                "otype": "Composite",
                "nested": [
                    {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2},
                    {"otype": "Identity"},
                ],
            },
            "rgb_network": {"n_neurons": 32, "n_hidden_layers": 2},
            "surface_encoding": {
                "otype": "Composite",
                "nested": [
                    {
                        "n_dims_to_encode": 2,
                        "otype": "HashGrid",
                        "n_levels": 8,
                        "n_features_per_level": 2,
                        "log2_hashmap_size": 12,
                        "base_resolution": 16,
                        "per_level_scale": 1.3819,
                    },
                    {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 2},
                ],
            },
            "surface_network": {"n_neurons": 32, "n_hidden_layers": 2},
        },
    }
    if occupancy:
        cfg["occupancy"] = {
            "resolution": [16, 16, 8],
            "n_probe": 16,
            "n_fine": num_samples,
            "update_every": 4,
        }
    return cfg


NERF_CONFIG = {
    "type": "NeRF",
    "include_height": False,
    "point_preprocessor": "horizontal",
    "num_bands": 4,
    "ray_origin_height": 20000,
    "sampler": {"N_c": 8, "N_f": 16},
    "encoder": {"L_x": [5, 5, 4], "L_d": 2},
    "mlp_hidden_dim": 32,
}


def _trainer_config(n_devices: int) -> dict:
    return {
        "all_gpu": True,
        "num_workers": 0,
        "batch_size": 8 * n_devices,
        "num_iters": 2,
        "print_frequency": 10,
        "optimizer": {"lr": 1e-2},
        "scheduler": {"type": "fixed", "gamma": 0.33, "decay_start": 10, "decay_interval": 10},
    }


def _build(device: torch.device, num_samples: int = 32, occupancy: bool = False):
    """The 12x8-pixel granule's dataset and the tiny pipeline at the JAX
    entry's parameters."""
    from atmonr_tpu_torch import convert, get_pipeline
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule

    granule = make_synthetic_granule(height=12, width=8, views_per_band=2)
    dataset = HARP2Dataset(DATASET_CONFIG, granule, device=device)
    config = _tiny_ngp_config(num_samples, occupancy)
    pipe = get_pipeline(config, dataset, device=device)
    pipe.load_params(convert.params_from_jax(convert.jax_ngp_init(config, 0)))
    return dataset, pipe


def entry(device: str | torch.device | None = None):
    """``(forward_step, (pipeline, batch))``: the deterministic forward and
    loss of the tiny Instant-NGP pipeline on the granule's first 64 rays,
    on ``device`` (``cuda`` unless given; raises when there is no card)."""
    from atmonr_tpu_torch.utils.device import resolve_device

    dataset, pipe = _build(resolve_device(device))
    keys = ("origin", "dir", "len", "rad", "irgb_idx")
    batch = {k: v[:ENTRY_RAYS] for k, v in dataset.rays(pipe.device).items() if k in keys}

    def forward_step(pipeline, batch):
        results = pipeline(batch)
        loss = pipeline.compute_loss(batch, results)
        return loss, results["color_map_fine"]

    return forward_step, (pipe, batch)


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> list[dict]:
    """The three multi-device modes on ``n_devices`` ranks (gloo on the CPU,
    NCCL on the cards); prints the JAX dry run's three lines and returns
    what each rank reports: each mode's mesh, batch and losses, and the
    kernels' launch counts of the rank."""
    import torch.multiprocessing as mp

    from atmonr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be positive, not {n}")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} cards; there are {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as root:
        mp.start_processes(_rank_entry, args=(n, root, dev.type), nprocs=n, join=True,
                           start_method="spawn")
        ranks = [torch.load(Path(root) / f"rank{r}.pt", weights_only=False) for r in range(n)]
    first = ranks[0]
    m1, m3 = first["sharded_step"], first["granules"]
    print(f"dryrun_multichip OK: mesh=(data={m1['data']}, sample={m1['sample']}), "
          f"batch={m1['batch']}, occupancy=on, loss={m1['loss']:.5f}")
    print(f"dryrun_multichip OK: NeRF mesh=(data={n}), batch={8 * n}")
    print(f"dryrun_multichip OK: multi-granule groups={m3['groups']}, pipelines=InstantNGP")
    return ranks


def _rank_entry(rank: int, world: int, root: str, device_type: str) -> None:
    """One rank: join the group, run the modes, save the rank's report."""
    import torch.distributed as dist

    # TensorBoard's writer runs on its own stub; importing TensorFlow, where
    # it is installed, takes many seconds a rank
    sys.modules["tensorflow"] = None
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    else:
        torch.set_num_threads(1)
        dev, backend = torch.device("cpu"), "gloo"
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        report = _run_modes(world, dev, Path(root))
        torch.save(report, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_modes(n: int, dev: torch.device, root: Path) -> dict:
    from atmonr_tpu_torch import Trainer, get_pipeline
    from atmonr_tpu_torch.data.batching import epoch_permutation
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.ops.hash_bwd import hash_bwd
    from atmonr_tpu_torch.ops.hash_gather import hash_gather
    from atmonr_tpu_torch.parallel.mesh import in_mesh, make_mesh
    from atmonr_tpu_torch.parallel.sharding import replicate, shard_rays
    from atmonr_tpu_torch.parallel.train import make_ngp_sharded_train_step
    from atmonr_tpu_torch.training.multi import partition_devices, train_granules

    report = {}
    # mode 1: the sample-sharded Instant-NGP step with the occupancy grid
    sample = 2 if n % 2 == 0 else 1
    data = n // sample
    mesh = make_mesh(data=data, sample=sample)
    dataset, pipe = _build(dev, num_samples=32, occupancy=True)
    opt = pipe.make_optimizer(
        {"lr": 1e-2, "betas": (0.9, 0.99), "eps": 1e-15, "weight_decay": 1e-2}, 1e-2)
    replicate(pipe, mesh)
    rays = shard_rays(dataset.rays(dev), mesh)
    rank_batch = 8
    step = make_ngp_sharded_train_step(pipe, opt, mesh, rank_batch)
    perm = epoch_permutation(torch.Generator(dev).manual_seed(0),
                             next(iter(rays.values())).shape[0], rank_batch)
    losses = [float(step(rays, perm, 0))]
    pipe.update_aux(generator=torch.Generator(dev).manual_seed(1))
    losses.append(float(step(rays, perm, 1)))
    if not np.isfinite(losses[-1]):
        raise RuntimeError(f"the sharded step's loss is {losses[-1]}")
    report["sharded_step"] = {"data": data, "sample": sample, "batch": rank_batch * data,
                              "losses": losses, "loss": losses[-1]}

    # mode 2: NeRF through the Trainer on a data mesh of every rank
    tcfg = _trainer_config(n)
    nerf = Trainer(dict(tcfg), dataset, get_pipeline(dict(NERF_CONFIG), dataset, device=dev),
                   "dryrun_nerf", data_root=root / "nerf", device=dev)
    nerf.shard(make_mesh(data=n))
    nerf.train(root / "nerf" / "out")
    if nerf.iter_count != 2:
        raise RuntimeError(f"the NeRF trainer stopped at {nerf.iter_count} iterations")
    report["nerf"] = {"iter_count": nerf.iter_count, "loss": float(nerf.last_loss)}

    # mode 3: two granule groups, each a data mesh of its ranks
    groups = partition_devices(2, range(n))
    meshes = [make_mesh(data=len(group), ranks=group) for group in groups]
    trainers, outs = [], []
    for g, gmesh in enumerate(meshes):
        if not in_mesh(gmesh):
            continue
        granule = make_synthetic_granule(height=10, width=8, views_per_band=2, seed=g)
        ds_g = HARP2Dataset(DATASET_CONFIG, granule, device=dev)
        t = Trainer(dict(tcfg), ds_g, get_pipeline(_tiny_ngp_config(), ds_g, device=dev),
                    f"dryrun_mg{g}", data_root=root / f"mg{g}", seed=g, device=dev)
        t.shard(gmesh)
        trainers.append(t)
        outs.append(root / f"mg{g}" / "out")
    train_granules(trainers, outs)
    if any(t.iter_count != 2 for t in trainers):
        raise RuntimeError(f"granule trainers stopped at {[t.iter_count for t in trainers]}")
    report["granules"] = {"groups": [len(g) for g in groups],
                          "iter_counts": [t.iter_count for t in trainers],
                          "losses": [float(t.last_loss) for t in trainers]}
    report["launches"] = {"K1": dict(hash_gather.launches), "K2": dict(hash_bwd.launches)}
    return report
