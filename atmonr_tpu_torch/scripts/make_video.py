"""Make an orbit video of an extracted extinction volume.

    python -m atmonr_tpu_torch.scripts.make_video --extract-filepath demo.nc \\
        --vdb-filepath demo.vdb --video-filepath demo.mp4

Reads an extract netCDF (``atmonr_tpu_torch.scripts.extract`` with
``l1c`` or ``voxelgrid``) and renders an orbit into ``_temp_frames/`` under
the working directory, one PGM a frame. Two renderers:

- ``--renderer vdb``: writes a km-scale OpenVDB grid and runs OpenVDB's
  ``vdb_render`` once a frame (both optional host dependencies);
- ``--renderer internal``: the port's own volume renderer
  (``atmonr_tpu_torch.extract.orbit_render``) on ``--device`` (``cuda`` by
  default; pass ``cpu`` to render there).

``auto`` (the default) takes vdb where OpenVDB imports, else internal.
ffmpeg, where present, stitches the frames into the video and removes
them; without it the frames stay. The flags of the JAX package's
``scripts/make_video.py``, plus ``--device``.
"""

import argparse
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--extract-filepath", type=str, required=True)
    parser.add_argument("--vdb-filepath", type=str, required=True)
    parser.add_argument("--video-filepath", type=str, required=True)
    parser.add_argument("--render-band-idx", type=int, default=2, help="Band to render.")
    parser.add_argument("--res", type=str, default="640x480")
    parser.add_argument("--frame-rate", type=int, default=60)
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--absorb", nargs=3, type=float, default=(0.1, 0.1, 0.1))
    parser.add_argument("--cutoff", type=float, default=0.01)
    parser.add_argument("--light-source-dir", nargs=3, type=float, default=(0.0, 1.0, 0.0))
    parser.add_argument("--light-source-color", nargs=3, type=float, default=(1.0, 1.0, 1.0))
    parser.add_argument("--scatter", nargs=3, type=float, default=(0.7, 0.7, 0.7))
    parser.add_argument(
        "--renderer",
        choices=("auto", "vdb", "internal"),
        default="auto",
        help="'vdb' = OpenVDB + vdb_render; 'internal' = the port's own "
        "volume renderer (no native dependencies).",
    )
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu.")
    args = parser.parse_args(argv)
    if not Path(args.extract_filepath).exists():
        parser.error(f"--extract-filepath {args.extract_filepath} does not exist")
    args.res = [int(pix) for pix in args.res.split("x")]
    if not (len(args.res) == 2 and args.res[0] > 0 and args.res[1] > 0):
        parser.error("--res must be <width>x<height>")
    if args.res[0] * args.res[1] > 1920 * 1080:
        warnings.warn(f"Rendering at {args.res} will be slow and may exhaust memory.")
    if not args.duration > 0:
        parser.error("--duration must be positive")
    return args


def volume_for_render(sigma: np.ndarray, band_idx: int) -> np.ndarray:
    """(along, across, vertical, bands) extinction, as the extract netCDF
    holds it, -> the (across, vertical, along) volume of one band that the
    renderers take: height on the y axis, the vertical ladder reversed. A
    band the extract does not have falls back to band 0 with a warning."""
    if band_idx >= sigma.shape[-1]:
        warnings.warn(
            f"band {band_idx} not in extract ({sigma.shape[-1]} band(s), "
            "single-band extinction); rendering band 0."
        )
        band_idx = 0
    return np.ascontiguousarray(np.transpose(sigma[:, :, ::-1, band_idx], (1, 2, 0)))


def read_extract_sigma(path: str, band_idx: int):
    """Read an extract netCDF's extinction (fill values as NaN) as the
    volume the renderers take, and the scene scale."""
    import h5py

    with h5py.File(path, "r") as f:
        full = np.array(f["extinction_coefficient"][()])
        fill = f["extinction_coefficient"].attrs.get("_FillValue")
        if fill is not None:
            full[full == np.asarray(fill).ravel()[0]] = np.nan
        scene_scale = float(f.attrs["neural_rendering_scene_scale"])
    return volume_for_render(full, band_idx), scene_scale


def _render_frames_vdb(args, sigma, scene_scale) -> None:
    """OpenVDB grid + one ``vdb_render`` run a frame."""
    try:
        import pyopenvdb as vdb  # type: ignore
    except ImportError:
        import openvdb as vdb  # type: ignore

    grid = vdb.FloatGrid()
    # km scale works well with vdb_render
    grid.copyFromArray(sigma * scene_scale / 1000)
    vdb.write(args.vdb_filepath, grids=[grid])

    num_frames = int(args.duration * args.frame_rate)
    times = np.linspace(0, args.duration, num_frames)
    center = (sigma.shape[0] / 2, sigma.shape[1] / 2, sigma.shape[2] / 2)

    orbit_radius = 1.3 * np.linalg.norm(sigma.shape)
    t_circle = 2 * np.pi * times / args.duration
    orbit_x = np.cos(t_circle) * orbit_radius + center[0]
    orbit_y = np.sin(t_circle) * orbit_radius + center[2]
    view_height = 0.5 * np.linalg.norm(sigma.shape)
    lookat = f"{center[0]},0,{center[2]}"

    res = "x".join(str(pix) for pix in args.res)
    absorb = ",".join(str(el) for el in args.absorb)
    light = ",".join(
        str(el) for el in list(args.light_source_dir) + list(args.light_source_color)
    )
    scatter = ",".join(str(el) for el in args.scatter)
    for idx in range(times.shape[0]):
        frame_file = f"_temp_frames/{idx:06d}.ppm"
        cmd = (
            f"vdb_render {args.vdb_filepath} {frame_file} -compression none "
            f"-lookat {lookat} -translate "
            f"{orbit_x[idx]},{view_height},{orbit_y[idx]} -res {res} "
            f"-absorb {absorb} -cutoff {args.cutoff} -light {light} "
            f"-scatter {scatter}"
        )
        subprocess.run(cmd.split(" "), stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)


def _render_frames_internal(args, sigma, scene_scale) -> None:
    """The port's own volume renderer on ``args.device``."""
    from atmonr_tpu_torch.extract.orbit_render import render_orbit, write_ppm

    num_frames = int(args.duration * args.frame_rate)
    frames = render_orbit(
        sigma * scene_scale / 1000,
        num_frames,
        width=args.res[0],
        height=args.res[1],
        device=args.device,
    )
    for idx, frame in enumerate(frames):
        write_ppm(f"_temp_frames/{idx:06d}.ppm", frame)


def main(argv=None) -> None:
    args = parse_args(argv)
    renderer = args.renderer
    if renderer == "auto":
        renderer = "internal"
        for name in ("pyopenvdb", "openvdb"):
            try:
                __import__(name)
            except ImportError:
                continue
            renderer = "vdb"
            break

    sigma, scene_scale = read_extract_sigma(args.extract_filepath, args.render_band_idx)
    if Path("_temp_frames").exists():
        shutil.rmtree("_temp_frames")
    os.makedirs("_temp_frames", exist_ok=True)
    if renderer == "vdb":
        _render_frames_vdb(args, sigma, scene_scale)
    else:
        _render_frames_internal(args, sigma, scene_scale)

    if shutil.which("ffmpeg") is None:
        warnings.warn("ffmpeg not found; leaving rendered frames in _temp_frames/.")
        return
    res = "x".join(str(pix) for pix in args.res)
    ffmpeg_cmd = (
        f"ffmpeg -framerate {args.frame_rate} -i _temp_frames/%06d.ppm "
        f"-c:v libx264 -pix_fmt yuv420p -s {res} -y {args.video_filepath}"
    )
    subprocess.run(ffmpeg_cmd.split(" "), stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    shutil.rmtree("_temp_frames")


if __name__ == "__main__":
    main()
