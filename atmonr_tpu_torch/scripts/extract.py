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
run there). ``--mesh`` needs multi-device extraction, which is not ported
yet, and raises.
"""

import argparse
import json
import time
import warnings
from pathlib import Path
from typing import Any, NamedTuple

EARTH_RADIUS = 6.378e6
MESH_NOT_PORTED = (
    "--mesh: multi-device extraction is not ported yet (ROADMAP.md queue 1, 'Multi-device')"
)


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
    parser.add_argument("--mesh", type=str, default=None, help="Not ported yet; raises.")
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
    process."""
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(MESH_NOT_PORTED)

    from atmonr_tpu_torch import get_dataset, get_extract_dataset, get_pipeline, run_extraction
    from atmonr_tpu_torch.training.checkpoint import restore_params

    output_path = Path(args.data_root) / "output" / args.exp_name
    train_args = json.loads((output_path / "args.json").read_text())
    config = json.loads((output_path / "config.json").read_text())

    dataset = get_dataset(
        config["dataset"], train_args["scene_filename"], args.data_root, device=args.device
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
    print(
        f"{args.coord_mode} grid: {len(extract_dataset)} points, shape "
        f"{extract_dataset.shp}, built in {build_s:.2f} s"
    )

    pipeline = get_pipeline(config["pipeline"], dataset, device=args.device)
    epoch = restore_params(output_path, pipeline)
    t0 = time.perf_counter()
    sigma = run_extraction(pipeline, extract_dataset, args.batch_size, verbose=True)
    query_s = time.perf_counter() - t0
    print(
        f"queried epoch {epoch}'s field at {len(extract_dataset)} points in {query_s:.3f} s "
        f"= {len(extract_dataset) / query_s:.0f} points/s on {pipeline.device}"
    )
    path = output_path / args.extract_filename
    extract_dataset.dump(path, sigma)
    print(f"wrote {path}")
    return Extraction(extract_dataset, sigma, build_s, query_s, path)


if __name__ == "__main__":
    main()
