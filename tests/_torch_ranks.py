"""Rank-side code of the port's multi-rank CPU tests.

``spawn`` starts ``world`` processes (``torch.multiprocessing`` with the
``spawn`` start method: the pytest process has JAX initialized, which
``fork`` would copy), joins them in a gloo process group (NCCL, rank r on
card r, for the card tests) through a ``FileStore`` under the test's
``tmp_path`` (no port, so xdist workers never collide), runs one of the
functions below in each, and returns what each rank returned, through
files. Inputs go to the ranks as numpy arrays and
plain dicts. This module imports torch, numpy and the port only: the ranks
never import JAX.
"""

from __future__ import annotations

import itertools
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SCENE = "synthetic:16x8x2"
_calls = itertools.count()


def spawn(world: int, tmp_path: Path, fn, *args, backend: str = "gloo") -> list:
    """``fn(rank, world, *args)`` on ``world`` ranks of ``backend``; their
    results in rank order."""
    call = tmp_path / f"spawn_{fn.__name__}_{os.getpid()}_{next(_calls)}"
    call.mkdir(parents=True)
    mp.start_processes(
        _entry, args=(world, str(call), backend, fn, args), nprocs=world, join=True,
        start_method="spawn",
    )
    return [torch.load(call / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _skip_tensorflow() -> None:
    """TensorBoard's writer runs without TensorFlow (on its own stub), and
    importing TensorFlow, where it is installed, takes many seconds a rank:
    make its import fail in this process."""
    import sys

    sys.modules["tensorflow"] = None


def _entry(rank: int, world: int, call: str, backend: str, fn, args) -> None:
    _skip_tensorflow()
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(call, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, *args), os.path.join(call, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def port_dataset(dataset_config: dict):
    """The port's dataset of ``SCENE`` with the numpy float64 ray builder,
    the rays of the JAX package's dataset in these tests."""
    from atmonr_tpu_torch.data.factory import _synthetic_from_name
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.geo import wgs84

    return HARP2Dataset(dataset_config, _synthetic_from_name(SCENE), device="cpu",
                        ray_builder=wgs84.get_rays)


def port_pipeline(config: dict, params: dict | None, jitter=None):
    """The port's pipeline of ``config`` on the CPU with float32 MLP products,
    the given parameters (numpy, ``convert.params_from_jax``'s names) and an
    occupancy refresh with ``jitter`` where given."""
    from atmonr_tpu_torch import get_pipeline

    pipe = get_pipeline(dict(config["pipeline"]), port_dataset(config["dataset"]), device="cpu")
    pipe.compute_dtype = torch.float32
    if params is not None:
        pipe.load_params({k: torch.from_numpy(v) for k, v in params.items()})
    if jitter is not None:
        pipe.update_aux(jitter=torch.from_numpy(np.array(jitter)))
    return pipe


def _grads(pipe) -> dict[str, np.ndarray]:
    return {n: p.grad.numpy().copy() for n, p in pipe.named_parameters()}


def _batch(rays: dict, rows: slice) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in rays.items()}


# -- the functions the ranks run -------------------------------------------------------


def render_ranks(rank: int, world: int, z, color, sigma, w_color, w_trans) -> dict:
    """``render_sample_sharded`` of the same whole rays over 4 sample ranks
    (mesh 1x4) and over 2 (mesh 2x2: each data row its own pair), with the
    gradients of ``sum(color_map * w_color) + sum(trans_total * w_trans)``
    with respect to color and sigma (this rank's slice non-zero)."""
    from atmonr_tpu_torch.parallel.mesh import make_mesh
    from atmonr_tpu_torch.parallel.sharding import render_sample_sharded

    meshes = {4: make_mesh(data=1, sample=4), 2: make_mesh(data=2, sample=2)}
    out = {}
    for ns, mesh in meshes.items():
        c = torch.from_numpy(color).requires_grad_()
        s = torch.from_numpy(sigma).requires_grad_()
        cm, trans, alpha, weights = render_sample_sharded(torch.from_numpy(z), c, s, mesh)
        loss = (cm * torch.from_numpy(w_color)).sum() + (trans * torch.from_numpy(w_trans)).sum()
        loss.backward()
        out[ns] = {
            "coord": mesh.get_coordinate(), "color_map": cm.detach().numpy(),
            "trans_total": trans.detach().numpy(), "alpha": alpha.detach().numpy(),
            "weights": weights.detach().numpy(), "g_color": c.grad.numpy(),
            "g_sigma": s.grad.numpy(),
        }
    return out


def data_sharded_ranks(rank: int, world: int, cases: dict, rays: dict) -> dict:
    """``forward_loss_data_sharded`` at data = 4 (all ranks) and data = 2
    (ranks 0-1 and 2-3, each pair its own mesh) for each pipeline of
    ``cases`` ({name: (config, params)}), deterministic; then the backward
    and ``reduce_gradients``. Each rank takes its data index's rows of the
    batch ``rays``."""
    from atmonr_tpu_torch.parallel.data import data_rows
    from atmonr_tpu_torch.parallel.mesh import make_mesh, mesh_axes
    from atmonr_tpu_torch.parallel.train import forward_loss_data_sharded, reduce_gradients

    meshes = {4: make_mesh(data=4), 2: [make_mesh(data=2, ranks=r) for r in ([0, 1], [2, 3])]}
    meshes[2] = meshes[2][rank // 2]
    n = len(rays["origin"])
    out = {}
    for name, (config, params) in cases.items():
        pipe = port_pipeline(config, params)
        for d, mesh in meshes.items():
            axes = mesh_axes(mesh)
            rows = data_rows(n, axes.data.size, axes.data.index)
            pipe.zero_grad()
            loss, results = forward_loss_data_sharded(pipe, _batch(rays, rows), axes)
            loss.backward()
            reduce_gradients(list(pipe.named_parameters()), axes)
            out[(name, d)] = {
                "rows": (rows.start, rows.stop), "loss": float(loss.detach()),
                "results": {k: v.detach().numpy() for k, v in results.items()},
                "grads": _grads(pipe),
            }
    return out


def sample_sharded_ranks(rank: int, world: int, config: dict, params: dict, jitter,
                         rays: dict) -> dict:
    """``ngp_forward_sample_sharded`` with the occupancy grid,
    deterministic, on mesh 2x2 (data 2, sample 2) and mesh 1x4 (sample 4);
    then each data index's share of the loss backward and
    ``reduce_gradients``."""
    from atmonr_tpu_torch.parallel.data import data_rows
    from atmonr_tpu_torch.parallel.mesh import make_mesh, mesh_axes
    from atmonr_tpu_torch.parallel.train import ngp_forward_sample_sharded, reduce_gradients

    pipe = port_pipeline(config, params, jitter)
    n = len(rays["origin"])
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(*shape)
        axes = mesh_axes(mesh)
        rows = data_rows(n, axes.data.size, axes.data.index)
        batch = _batch(rays, rows)
        pipe.zero_grad()
        results = ngp_forward_sample_sharded(pipe, batch, axes)
        loss = pipe.compute_loss(batch, results) / axes.data.size
        loss.backward()
        loss = reduce_gradients(list(pipe.named_parameters()), axes, loss)
        out[shape] = {
            "coord": mesh.get_coordinate(), "rows": (rows.start, rows.stop),
            "results": {k: v.detach().numpy() for k, v in results.items()},
            "grads": _grads(pipe), "loss": float(loss),
        }

    # make_ngp_sharded_train_step on mesh 2x2: each data index steps through
    # its own rows of the first 8 batches of the ray set
    from atmonr_tpu_torch.parallel.train import make_ngp_sharded_train_step

    mesh = make_mesh(2, 2)
    data = mesh_axes(mesh).data
    all_rays = port_dataset(config["dataset"]).host_rays()
    sl = data_rows(len(all_rays["origin"]), data.size, data.index)
    local = {k: torch.from_numpy(np.ascontiguousarray(v[sl])) for k, v in all_rays.items()}
    opt = pipe.make_optimizer(
        {"lr": 1e-2, "betas": (0.9, 0.99), "eps": 1e-15, "weight_decay": 1e-2}, 1e-2)
    step = make_ngp_sharded_train_step(pipe, opt, mesh, 32)
    perm = torch.randperm(sl.stop - sl.start, generator=torch.Generator().manual_seed(0))
    out["train_step"] = {
        "losses": [float(step(local, perm, i)) for i in range(8)],
        "state": {k: v.numpy().copy() for k, v in pipe.state_dict().items()},
    }
    return out


def trainer_ranks(rank: int, world: int, config: dict, nerf_config: dict, root: str) -> dict:
    """Two Trainers at once, each over its own pair of ranks: ranks 0-1 on
    mesh data=2, ranks 2-3 on mesh data=1,sample=2. Each trains
    ``num_iters`` steps, writes its checkpoints, then a fresh Trainer loads
    the latest. Also what ``shard`` refuses."""
    from atmonr_tpu_torch import Trainer, get_pipeline
    from atmonr_tpu_torch.parallel.data import host_ray_slice, trimmed_ray_count
    from atmonr_tpu_torch.parallel.mesh import make_mesh
    from atmonr_tpu_torch.parallel.sharding import replicate, shard_rays

    meshes = [make_mesh(data=2, ranks=[0, 1]), make_mesh(data=1, sample=2, ranks=[2, 3])]
    group = rank // 2
    mesh = meshes[group]
    ds = port_dataset(config["dataset"])
    exp = Path(root) / f"group{group}"
    out_dir = exp / "out"

    def trainer(cfg):
        pipe = get_pipeline(dict(cfg["pipeline"]), ds, device="cpu")
        t = Trainer(dict(cfg["trainer"]), ds, pipe, "mesh", data_root=exp, seed=3, device="cpu")
        t.shard(mesh)
        return t

    tr = trainer(config)
    sl = host_ray_slice(len(ds), mesh)
    rows = shard_rays(ds.rays("cpu"), mesh)
    same_rows = all(torch.equal(rows[k], tr.rays[k]) for k in rows)
    mine = torch.full((3,), float(rank))
    replicate([mine], mesh)
    losses = []
    for _ in tr.iterate(out_dir):
        losses.append(float(tr.last_loss))
    state = {k: v.numpy().copy() for k, v in tr.pipeline.state_dict().items()}
    moments = [v.numpy().copy() for st in tr.optimizer.adamw.state.values()
               for v in st.values() if v.ndim]
    again = trainer(config)
    again.load(out_dir)
    loaded = {k: v.numpy().copy() for k, v in again.pipeline.state_dict().items()}
    refused = {}
    nerf = get_pipeline(dict(nerf_config["pipeline"]), ds, device="cpu")
    t = Trainer(dict(config["trainer"]), ds, nerf, "nerf", data_root=exp / "nerf", device="cpu")
    try:  # group 0's data-only mesh takes NeRF
        t.shard(mesh)
    except ValueError as e:
        refused["nerf"] = str(e)
    checked = get_pipeline(dict(config["pipeline"]), ds, device="cpu")
    t = Trainer(dict(config["trainer"], check_numerics=True), ds, checked, "cn",
                data_root=exp / "cn", device="cpu")
    try:
        t.shard(mesh)
    except ValueError as e:
        refused["check_numerics"] = str(e)
    return {
        "group": group, "slice": (sl.start, sl.stop), "n_trim": trimmed_ray_count(len(ds), mesh),
        "n_rays": len(ds), "rank_rays": tr.rank_rays, "rank_batch": tr.rank_batch,
        "batch_size": tr.batch_size, "iter_count": tr.iter_count, "epoch_idx": tr.epoch_idx,
        "losses": losses, "state": state, "moments": moments, "loaded": loaded,
        "loaded_iter": again.iter_count, "refused": refused,
        "draws_state": again.generators["draws"].get_state().numpy(),
        "is_main": tr.is_main, "same_rows": same_rows, "replicated": mine.tolist(),
    }


def card_mesh_ranks(rank: int, world: int, config: dict, root: str) -> dict:
    """The meshes across devices (cards over NCCL; CPU ranks over gloo to
    rehearse): every rank draws the same parameters and renders the same
    first ``B`` rays of the granule with K1 and K2, unsharded (the
    reference), then sample-sharded on mesh 1 x world and (world / 2) x 2
    with ``reduce_gradients``; then a ``Trainer`` on mesh data=world takes
    4 steps. Returns the relative L2 distance of each gradient from the
    reference, the loss, and every rank's trained parameters as gathered on
    this rank."""
    from atmonr_tpu_torch import Trainer, get_dataset, get_pipeline
    from atmonr_tpu_torch.parallel.data import data_rows
    from atmonr_tpu_torch.parallel.mesh import make_mesh, mesh_axes
    from atmonr_tpu_torch.parallel.train import ngp_forward_sample_sharded, reduce_gradients

    dev = torch.device("cuda", rank) if dist.get_backend() == "nccl" else torch.device("cpu")
    b = 256
    ds = get_dataset(config["dataset"], SCENE, device=dev)
    pipe = get_pipeline(dict(config["pipeline"]), ds, device=dev,
                        generator=torch.Generator().manual_seed(7))
    pipe.compute_dtype = torch.float32
    pipe.update_aux(jitter=torch.rand((pipe.occ_cfg.num_cells, 3),
                                      generator=torch.Generator().manual_seed(8)).to(dev))
    rays = {k: v[:b] for k, v in ds.rays(dev).items()}
    ref_loss = pipe.compute_loss(rays, pipe(rays))
    ref_loss.backward()
    ref = {n: p.grad.clone() for n, p in pipe.named_parameters()}
    out = {"ref_loss": float(ref_loss.detach())}
    for shape in ((1, world), (world // 2, 2)):
        axes = mesh_axes(make_mesh(*shape))
        rows = data_rows(b, axes.data.size, axes.data.index)
        batch = {k: v[rows] for k, v in rays.items()}
        pipe.zero_grad()
        loss = pipe.compute_loss(batch, ngp_forward_sample_sharded(pipe, batch, axes))
        loss = loss / axes.data.size
        loss.backward()
        loss = reduce_gradients(list(pipe.named_parameters()), axes, loss)
        out[shape] = {
            "loss": float(loss),
            "rel_l2": {n: float(torch.linalg.vector_norm(p.grad - ref[n])
                                / torch.linalg.vector_norm(ref[n]))
                       for n, p in pipe.named_parameters()},
        }
    mesh = make_mesh(data=world)
    tr = Trainer(dict(config["trainer"]), ds, get_pipeline(dict(config["pipeline"]), ds, device=dev),
                 "card_mesh", data_root=Path(root) / f"rank{rank}", seed=0, device=dev)
    tr.shard(mesh)
    for _ in range(4):
        tr.step(torch.randperm(tr.rank_rays, device=dev)[: tr.rank_batch])
    flat = torch.cat([p.detach().reshape(-1) for p in tr.pipeline.parameters()])
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    out["trained_equal"] = all(torch.equal(every[0], f) for f in every[1:])
    out["trained_loss"] = float(tr.last_loss)
    return out


def scaling_ranks(rank: int, world: int, granule: dict) -> dict:
    """``tools.bench_scaling.main`` over the world's gloo group at
    ``data=1`` (rank 0 alone) and ``data=2`` (both ranks), a few steps at a
    small size; this rank's rays/s by spec."""
    from atmonr_tpu_torch.tools import bench_scaling

    return bench_scaling.main(["data=1", "data=2"], device="cpu", iters=2, granule=granule,
                              base_batch=64, max_warm_iters=2, warm_block=1)


# -- under torchrun ------------------------------------------------------------------------


def _cli(argv: list[str]) -> None:
    """``python -m torch.distributed.run ... tests/_torch_ranks.py {train,extract}
    DUMP [CLI args]``: run the port's CLI in this rank, then save what the
    rank holds (the trained parameters and occupancy grid, or the sigma it
    returned) as ``DUMP/rank<RANK>.pt``."""
    _skip_tensorflow()
    mode, dump, args = argv[0], Path(argv[1]), argv[2:]
    if mode == "train":
        from atmonr_tpu_torch.scripts import train

        (trainer,) = train.main(args)
        held = {k: v.clone() for k, v in trainer.pipeline.state_dict().items()}
    else:
        from atmonr_tpu_torch.scripts import extract

        held = torch.from_numpy(extract.main(args).sigma)
    torch.save(held, dump / f"rank{os.environ['RANK']}.pt")


if __name__ == "__main__":
    import sys

    _cli(sys.argv[1:])
