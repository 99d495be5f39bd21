"""Train a neural rendering model to fit multi-angle satellite data.

    python -m atmonr_tpu_torch.scripts.train --exp-name demo \\
        --config-path configs/instant_ngp_tpu_occ13.json \\
        --scene-filename synthetic:128x64x2 --num-iters 200 --overwrite

The flags of the JAX package's ``scripts/train.py``, plus ``--device``
(``cuda`` by default; the run raises when there is no card, pass ``cpu`` to
train there). ``--scene-filename synthetic[:HxWxV]`` runs fully offline on a
generated granule. ``--mesh``, ``--distributed`` and several comma-separated
scenes need multi-device training, which is not ported yet, and raise.
"""

import argparse
import json
import os
from pathlib import Path


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
    parser.add_argument("--mesh", type=str, default=None, help="Not ported yet; raises.")
    parser.add_argument("--distributed", action="store_true", help="Not ported yet; raises.")
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


def main(argv=None) -> None:
    args = parse_args(argv)
    from atmonr_tpu_torch import Trainer, get_dataset, get_pipeline, load_config
    from atmonr_tpu_torch.training.trainer import MULTI_DEVICE_NOT_PORTED

    scenes = [s for s in args.scene_filename.split(",") if s]
    if args.mesh or args.distributed or len(scenes) > 1:
        raise NotImplementedError(MULTI_DEVICE_NOT_PORTED)

    config = load_config(args.config_path)
    if args.num_iters is not None:
        config["trainer"]["num_iters"] = args.num_iters
    if args.check_numerics:
        config["trainer"]["check_numerics"] = True
    args.scene_filename = scenes[0]  # normalized form into args.json
    output_path = setup_dir(args, config)

    dataset = get_dataset(config["dataset"], scenes[0], args.data_root, device=args.device)
    pipeline = get_pipeline(config["pipeline"], dataset, device=args.device)
    trainer = Trainer(
        config["trainer"],
        dataset,
        pipeline,
        args.exp_name,
        data_root=args.data_root,
        seed=args.seed,
        device=args.device,
    )
    if args.resume:
        trainer.load(output_path)
    trainer.install_preemption_handler()
    trainer.train(output_path, profile=args.profile)


if __name__ == "__main__":
    main()
