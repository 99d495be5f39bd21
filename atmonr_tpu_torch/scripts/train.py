"""Train a neural rendering model to fit multi-angle satellite data.

    python -m atmonr_tpu_torch.scripts.train --exp-name demo \\
        --config-path configs/instant_ngp_tpu_occ13.json \\
        --scene-filename synthetic:128x64x2 --num-iters 200 --overwrite

The flags of the JAX package's ``scripts/train.py``, plus ``--device``
(``cuda`` by default; the run raises when there is no card, pass ``cpu`` to
train there). ``--scene-filename synthetic[:HxWxV]`` runs fully offline on a
generated granule.

Several devices: one process per device, launched by torchrun; ``--mesh``
(or ``--distributed``) joins the process group from torchrun's environment
(NCCL on cards, gloo with ``--device cpu``), and each rank trains on
``cuda:LOCAL_RANK``:

    torchrun --nproc-per-node 4 -m atmonr_tpu_torch.scripts.train \
        --mesh data=4 --exp-name demo ...

``--mesh data=N[,sample=M]`` shards the rays over N data indices (and each
ray's samples over M, Instant-NGP only); ``--distributed`` without
``--mesh`` trains the same model on every rank, as the JAX package does.
A comma-separated ``--scene-filename`` trains one model per granule
(``training/multi.py``), each in ``<exp>/granule_<g>/`` with its own
``args.json`` and ``config.json``: in one process, granule g on
``cuda:(g % device_count)``; under torchrun, each contiguous group of ranks
trains one granule (over ``--mesh``'s shape when given).
"""

import argparse
import json
import os
from pathlib import Path

import torch
import torch.distributed as dist


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--exp-name", type=str, required=True)
    parser.add_argument("--config-path", type=str, required=True)
    parser.add_argument("--scene-filename", type=str, required=True)
    parser.add_argument(
        "--profile",
        action="store_true",
        help="Capture a torch.profiler trace of the first epoch.",
    )
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument(
        "--mesh",
        type=str,
        default=None,
        help="Device mesh spec 'data=N' or 'data=N,sample=M' over torchrun's "
        "processes (default: single device).",
    )
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="Join the process group from torchrun's environment (also "
        "implied by --mesh); each rank then feeds only its rows of the ray set.",
    )
    parser.add_argument(
        "--check-numerics",
        action="store_true",
        help="Debug mode: raise at the first non-finite loss or gradient, "
        "naming the step (costs a host sync per iteration).",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data-root", type=str, default="data")
    parser.add_argument(
        "--num-iters", type=float, default=None, help="Override trainer.num_iters."
    )
    parser.add_argument(
        "--device", type=str, default=None, help="cuda (default) or cpu."
    )
    return parser.parse_args(argv)


def setup_dir(args: argparse.Namespace, config: dict) -> Path:
    """Make (or, with ``--resume``, find) the experiment's directory and
    write ``args.json`` and ``config.json`` there."""
    output_path = Path(args.data_root) / "output" / args.exp_name
    if args.resume:
        if not output_path.exists():
            raise FileNotFoundError(f"--resume: {output_path} does not exist")
    elif output_path.exists() and not args.overwrite:
        raise FileExistsError(f"{output_path} exists; pass --overwrite or --resume")
    os.makedirs(output_path, exist_ok=True)
    with open(output_path / "args.json", "w") as f:
        json.dump(vars(args), f, indent=4)
    with open(output_path / "config.json", "w") as f:
        json.dump(config, f, indent=4)
    return output_path


def main(argv=None) -> list:
    """Train; returns the trainers (one per granule this rank trains), for
    callers in the same process. A process group that ``--mesh`` or
    ``--distributed`` joined is left again at the end."""
    args = parse_args(argv)
    from atmonr_tpu_torch.parallel import mesh as pmesh

    joined = (args.mesh or args.distributed) and not dist.is_initialized()
    if joined:
        pmesh.initialize_distributed(args.device)
    try:
        return _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> list:
    from atmonr_tpu_torch import Trainer, get_dataset, get_pipeline, load_config
    from atmonr_tpu_torch.parallel import mesh as pmesh
    from atmonr_tpu_torch.training.multi import partition_devices, train_granules

    config = load_config(args.config_path)
    if args.num_iters is not None:
        config["trainer"]["num_iters"] = args.num_iters
    if args.check_numerics:
        config["trainer"]["check_numerics"] = True
    scenes = [s for s in args.scene_filename.split(",") if s]
    args.scene_filename = ",".join(scenes)  # normalized form into args.json
    distributed = dist.is_initialized()
    device = pmesh.rank_device(args.device) if distributed else args.device
    # every rank builds every mesh, in order (one per granule); a mesh
    # larger than the world raises here, naming the torchrun line
    meshes = None
    if distributed and len(scenes) > 1:
        groups = partition_devices(len(scenes), range(dist.get_world_size()))
        meshes = [
            pmesh.make_mesh_from_spec(args.mesh, ranks=group)
            if args.mesh else pmesh.make_mesh(ranks=group)
            for group in groups
        ]
    elif args.mesh:
        meshes = [pmesh.make_mesh_from_spec(args.mesh)]

    output_path = Path(args.data_root) / "output" / args.exp_name
    if pmesh.is_first_rank(None):
        output_path = setup_dir(args, config)
    if distributed:
        dist.barrier()

    def make_trainer(g: int, dev) -> Trainer:
        name = args.exp_name if len(scenes) == 1 else f"{args.exp_name}_granule{g}"
        dataset = get_dataset(config["dataset"], scenes[g], args.data_root, device=dev)
        pipeline = get_pipeline(config["pipeline"], dataset, device=dev)
        return Trainer(
            config["trainer"], dataset, pipeline, name, data_root=args.data_root,
            seed=args.seed + g, device=dev,
        )

    if len(scenes) == 1:
        trainer = make_trainer(0, device)
        if meshes:
            trainer.shard(meshes[0])
        if args.resume:
            trainer.load(output_path)
        trainer.install_preemption_handler()
        trainer.train(output_path, profile=args.profile)
        return [trainer]

    # one model per granule, each on its own devices (training/multi.py)
    if meshes is None:
        cards = partition_devices(len(scenes), ["cpu"] if device == "cpu" else None)
    trainers, out_paths = [], []
    for g in range(len(scenes)):
        if meshes is not None:
            if not pmesh.in_mesh(meshes[g]):
                continue
            trainer = make_trainer(g, device)
            trainer.shard(meshes[g])
        else:
            dev = torch.device(cards[g][0])
            trainer = make_trainer(g, dev.type)
            trainer.place(dev)
        out = output_path / f"granule_{g}"
        if trainer.is_main:
            # per-granule args and config, so that extract targets
            # <exp>/granule_<g>
            out.mkdir(parents=True, exist_ok=True)
            with open(out / "args.json", "w") as f:
                json.dump(dict(vars(args), scene_filename=scenes[g]), f, indent=4)
            with open(out / "config.json", "w") as f:
                json.dump(config, f, indent=4)
        if meshes is not None:
            pmesh.mesh_barrier(meshes[g])
        if args.resume:
            trainer.load(out)
        trainers.append(trainer)
        out_paths.append(out)
    train_granules(trainers, out_paths, profile=args.profile)
    return trainers


if __name__ == "__main__":
    main()
