"""Extract the extinction field of a trained model on a grid and write it.

    python -m atmonr_tpu_torch.scripts.extract --exp-name demo \\
        --coord-mode l1c --extract-filename demo.nc

Reads ``args.json`` and ``config.json`` of the experiment under
``<data-root>/output/<exp-name>/`` (as ``atmonr_tpu_torch.scripts.train``
writes them), rebuilds the dataset, restores the latest checkpoint, builds
the grid of ``--coord-mode`` (``l1c``, ``voxelgrid``, ``globalgrid`` or
``earthcare``), queries it in batches on the card and writes netCDF (OpenVDB,
or a ``.npy`` pair, for ``globalgrid``) to ``<output>/<extract-filename>``.
The flags of the JAX package's ``scripts/extract.py``, plus ``--device``
(``cuda`` by default; the run raises when there is no card, pass ``cpu`` to
run there). ``--mesh data=N[,sample=M]`` splits every batch over the N*M
processes that torchrun launched (one per device, ``cuda:LOCAL_RANK``;
gloo with ``--device cpu``); the first rank writes:

    torchrun --nproc-per-node 4 -m atmonr_tpu_torch.scripts.extract \
        --mesh data=4 --exp-name demo --coord-mode l1c --extract-filename demo.nc
"""

import argparse
import json
import time
import warnings
from pathlib import Path
from typing import Any, NamedTuple

EARTH_RADIUS = 6.378e6


class Extraction(NamedTuple):
    """What ``main`` did: the grid, its sigma (N, bands) in m^-1, the host
    seconds of the grid build and of the query (``run_extraction``, both
    copies included), and the file written."""

    grid: Any
    sigma: Any
    build_s: float
    query_s: float
    path: Path


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--exp-name", type=str, required=True)
    parser.add_argument(
        "--coord-mode",
        type=str,
        required=True,
        help="'l1c', 'voxelgrid', 'globalgrid', or 'earthcare'.",
    )
    parser.add_argument("--extract-filename", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=32768)
    parser.add_argument("--min-alt", type=float)
    parser.add_argument("--max-alt", type=float)
    parser.add_argument("--alt-step", type=float, default=250.0)
    parser.add_argument("--horizontal-step", type=float, default=3000.0)
    parser.add_argument("--scale", type=float, default=100 / EARTH_RADIUS)
    parser.add_argument("--grid-res", type=float, default=0.025)
    parser.add_argument("--vstretch", type=float, default=12)
    parser.add_argument("--lon-crop", type=float, default=0.05)
    parser.add_argument("--earthcare-filename", type=str)
    parser.add_argument(
        "--earthcare-range", type=lambda s: [int(v) for v in s.split(",")]
    )
    parser.add_argument("--data-root", type=str, default="data")
    parser.add_argument(
        "--mesh",
        type=str,
        default=None,
        help="Device mesh spec 'data=N' or 'data=N,sample=M' over torchrun's "
        "processes: shard every query batch over all of its ranks.",
    )
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu.")
    args = parser.parse_args(argv)
    args.coord_mode = args.coord_mode.lower()
    if not (args.alt_step > 0 and args.horizontal_step > 0):
        parser.error("--alt-step and --horizontal-step must be positive")
    if not (args.scale > 0 and args.grid_res > 0 and args.vstretch >= 1):
        parser.error("--scale and --grid-res must be positive and --vstretch at least 1")
    if args.alt_step <= 50:
        warnings.warn(f"--alt-step {args.alt_step} is very low; extraction may be slow.")
    if args.horizontal_step <= 500:
        warnings.warn(
            f"--horizontal-step {args.horizontal_step} is very low; extraction may be slow."
        )
    return args


def main(argv=None) -> Extraction:
    """Run the extraction; returns what it did, for callers in the same
    process. A process group that ``--mesh`` joined is left again at the
    end."""
    args = parse_args(argv)
    import torch.distributed as dist

    from atmonr_tpu_torch.parallel import mesh as pmesh

    joined = bool(args.mesh) and not dist.is_initialized()
    if joined:
        pmesh.initialize_distributed(args.device)
    try:
        return _extract(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _extract(args: argparse.Namespace) -> Extraction:
    from atmonr_tpu_torch import get_dataset, get_extract_dataset, get_pipeline, run_extraction
    from atmonr_tpu_torch.parallel import mesh as pmesh
    from atmonr_tpu_torch.training.checkpoint import restore_params

    mesh, device = None, args.device
    if args.mesh:
        mesh = pmesh.make_mesh_from_spec(args.mesh)  # raises when the world is too small
        device = pmesh.rank_device(args.device)
    output_path = Path(args.data_root) / "output" / args.exp_name
    train_args = json.loads((output_path / "args.json").read_text())
    config = json.loads((output_path / "config.json").read_text())
    first = pmesh.is_first_rank(mesh)
    dataset = get_dataset(
        config["dataset"], train_args["scene_filename"], args.data_root, device=device
    )
    t0 = time.perf_counter()
    extract_dataset = get_extract_dataset(
        args.coord_mode,
        dataset,
        alt_step=args.alt_step,
        min_alt=args.min_alt,
        max_alt=args.max_alt,
        horizontal_step=args.horizontal_step,
        scale=args.scale,
        grid_res=args.grid_res,
        vstretch=args.vstretch,
        lon_crop=args.lon_crop,
        earthcare_filename=args.earthcare_filename,
        earthcare_range=args.earthcare_range,
        data_root=args.data_root,
    )
    build_s = time.perf_counter() - t0
    say = print if first else (lambda *a, **k: None)
    say(
        f"{args.coord_mode} grid: {len(extract_dataset)} points, shape "
        f"{extract_dataset.shp}, built in {build_s:.2f} s"
    )

    pipeline = get_pipeline(config["pipeline"], dataset, device=device)
    epoch = restore_params(output_path, pipeline)
    t0 = time.perf_counter()
    sigma = run_extraction(pipeline, extract_dataset, args.batch_size, verbose=first, mesh=mesh)
    query_s = time.perf_counter() - t0
    say(
        f"queried epoch {epoch}'s field at {len(extract_dataset)} points in {query_s:.3f} s "
        f"= {len(extract_dataset) / query_s:.0f} points/s on {pipeline.device}"
    )
    path = output_path / args.extract_filename
    if first:
        extract_dataset.dump(path, sigma)
        print(f"wrote {path}")
    if mesh is not None:
        pmesh.mesh_barrier(mesh)  # the file is there when any rank returns
    return Extraction(extract_dataset, sigma, build_s, query_s, path)


if __name__ == "__main__":
    main()
