"""Real-granule-scale demonstration on one card: the counterpart of the JAX
repo's ``tools/real_scale_demo.py``.

A real HARP2 granule is ~457x457 pixels x 90 views (10-60 a band), of
which the view-angle filter keeps most: ~14.6 M rays at the flagship's 45
degrees, all resident on the device. End to end:

1. the granule in the real PACE_HARP2 L1B schema
   (``data/synthetic.py``: 90 views, fill coding, striped red views), from
   ``source=file``: written with ``write_granule_l1b_real_schema`` and read
   back by the production reader (h5py), or ``source=memory``: the same
   arrays from ``real_schema_granule``, with no file (where h5py is not
   installed);
2. the dataset (the host library's ray build, the filter, the
   normalization), its ray count and the ray store's size;
3. the flagship's train step (``Trainer.step``, seed 0, the config's
   trainer block) at 8,192 rays: the first step, 59 warm steps, then the
   timed steps; steady rays/s and peak device memory;
4. a coarse voxelgrid extraction (20 km / 2 km, no DEM) through ``run_extraction``,
   written as netCDF under ``source=file`` only (the writer needs h5py).

    python -m atmonr_tpu_torch.tools.real_scale_demo [height=457] [width=457] [steps=200]
        [config=configs/instant_ngp_tpu_occ13.json] [source=file|memory]

The last line is the JSON report.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from atmonr_tpu_torch.tools import repo_path
from atmonr_tpu_torch.tools.ab_importance import BATCH_SIZE

WARM_STEPS = 59
EXTRACT_STEP = (20000.0, 2000.0)  # the voxelgrid's horizontal and altitude step, m
SOURCES = ("file", "memory")


def load_real_scale(dataset_config: dict, source: str, device: torch.device, root: Path,
                    height: int, width: int, **scene) -> tuple:
    """The real-schema granule of ``height`` x ``width`` pixels (``scene``:
    ``n_blobs``, ``blob_max``, ``noise``) and its ``HARP2Dataset`` on
    ``device``. ``source="file"`` writes it under ``root/HARP2/`` (unless the
    file is there already) and reads it through ``get_dataset``;
    ``source="memory"`` builds the same arrays with no file. Returns the
    dataset and the seconds and MB of the granule (the write and the file,
    or the build and its host arrays; ``None`` for a file already there)
    and the dataset's build seconds."""
    from atmonr_tpu_torch.data.factory import get_dataset
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import (
        REAL_SCHEMA_NAME, real_schema_granule, write_granule_l1b_real_schema,
    )

    if source not in SOURCES:
        raise ValueError(f"source must be one of {SOURCES}, got {source!r}")
    timings = {"granule_s": None, "granule_mb": None}
    t0 = time.perf_counter()
    if source == "file":
        path = Path(root) / "HARP2" / REAL_SCHEMA_NAME
        if not path.exists():
            write_granule_l1b_real_schema(path, height=height, width=width, **scene)
            timings["granule_s"] = time.perf_counter() - t0
            timings["granule_mb"] = path.stat().st_size / 1e6
        t0 = time.perf_counter()
        ds = get_dataset(dataset_config, REAL_SCHEMA_NAME, data_root=root, device=device)
    else:
        granule = real_schema_granule(height=height, width=width, **scene)
        timings["granule_s"] = time.perf_counter() - t0
        timings["granule_mb"] = sum(
            v.nbytes for v in vars(granule).values() if isinstance(v, np.ndarray)) / 1e6
        t0 = time.perf_counter()
        ds = HARP2Dataset(dataset_config, granule, device=device)
    timings["dataset_build_s"] = time.perf_counter() - t0
    return ds, timings


def device_memory(dev: torch.device) -> dict | str:
    """Peak allocated, free and total device MB; "not measured" off a card."""
    if dev.type != "cuda":
        return "not measured"
    free, total = torch.cuda.mem_get_info(dev)
    return {"max_allocated_mb": round(torch.cuda.max_memory_allocated(dev) / 1e6, 1),
            "free_mb": round(free / 1e6, 1), "total_mb": round(total / 1e6, 1)}


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         warm_steps: int = WARM_STEPS, batch_size: int = BATCH_SIZE,
         extract_step: tuple[float, float] = EXTRACT_STEP, keep: dict | None = None) -> dict:
    """Runs the demo on ``device`` (``cuda`` unless given) and returns the
    report. ``warm_steps``, ``batch_size`` and ``extract_step`` shrink it for
    a small granule. ``keep``, a dict, receives the dataset, the pipeline
    and the extraction grid for a caller that goes on with them."""
    from atmonr_tpu_torch import get_extract_dataset, get_pipeline, load_config, run_extraction
    from atmonr_tpu_torch.tools import batches, tool_trainer
    from atmonr_tpu_torch.utils.device import describe_device, resolve_device
    from atmonr_tpu_torch.utils.timing import fence

    argv = sys.argv[1:] if argv is None else argv
    height, width, steps = 457, 457, 200
    config_path = "configs/instant_ngp_tpu_occ13.json"
    source = "file"
    for a in argv:
        k, _, v = a.partition("=")
        if k == "height":
            height = int(v)
        elif k == "width":
            width = int(v)
        elif k == "steps":
            steps = int(v)
        elif k == "config":
            config_path = v
        elif k == "source":
            source = v

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = load_config(repo_path(config_path))
    report: dict = {"height": height, "width": width, "config": config_path,
                    "source": source, "steps": steps, "device": describe_device(dev)}

    with tempfile.TemporaryDirectory(prefix="real_scale_") as tmp:
        tmp = Path(tmp)
        ds, timings = load_real_scale(cfg["dataset"], source, dev, tmp, height, width)
        report["granule_s"] = round(timings["granule_s"], 1)
        report["granule_mb"] = round(timings["granule_mb"], 1)
        what = "written" if source == "file" else "built in memory"
        print(f"[1] granule {what}: {report['granule_mb']} MB in {report['granule_s']}s",
              flush=True)
        report["dataset_build_s"] = round(timings["dataset_build_s"], 1)
        report["num_rays"] = int(ds.num_rays)
        report["ray_store_mb"] = round(sum(v.nbytes for v in ds.host_rays().values()) / 1e6, 1)
        print(f"[2] dataset: {report['num_rays'] / 1e6:.1f} M rays "
              f"({report['ray_store_mb']} MB) built in {report['dataset_build_s']}s",
              flush=True)

        pipe = get_pipeline(cfg["pipeline"], ds, device=dev)
        with tool_trainer(cfg["trainer"], ds, pipe, "real_scale", batch_size=batch_size) as tr:
            rows = batches(tr)
            t0 = time.perf_counter()
            loss = tr.step(next(rows))
            float(loss)
            report["compile_s"] = round(time.perf_counter() - t0, 1)  # the kernels' builds
            for _ in range(warm_steps):
                loss = tr.step(next(rows))
            float(loss)
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = tr.step(next(rows))
            report["final_loss"] = float(loss)  # fences the queue
            dt = (time.perf_counter() - t0) / steps
            report["device_memory"] = device_memory(dev)
            b, n_steps = tr.batch_size, tr.iter_count
        del tr
        report["steady_rays_per_s"] = round(b / dt, 1)
        print(f"[3] training steady state: {report['steady_rays_per_s']:.0f} rays/s over "
              f"{steps} steps (loss {report['final_loss']:.4f}); device memory "
              f"{report['device_memory']}", flush=True)

        t0 = time.perf_counter()
        ex = get_extract_dataset("voxelgrid", ds, horizontal_step=extract_step[0],
                                 alt_step=extract_step[1])
        sigma = run_extraction(pipe, ex, batch_size=b)
        fence(dev)
        report["extract_points"] = int(len(ex))
        if source == "file":
            out_nc = tmp / "real_scale_voxelgrid.nc"
            ex.dump(out_nc, sigma)
            report["extract_s"] = round(time.perf_counter() - t0, 1)
            report["extract_file_mb"] = round(out_nc.stat().st_size / 1e6, 2)
            print(f"[4] voxelgrid extract: {report['extract_points']} points in "
                  f"{report['extract_s']}s -> {out_nc.name} "
                  f"({report['extract_file_mb']} MB)", flush=True)
        else:
            report["extract_s"] = round(time.perf_counter() - t0, 1)
            report["extract_file_mb"] = None
            print(f"[4] voxelgrid extract: {report['extract_points']} points in "
                  f"{report['extract_s']}s; not written: the netCDF writer needs h5py "
                  f"(source=file)", flush=True)
        if not np.all(np.isfinite(sigma)):
            raise RuntimeError("the extraction's sigma is not finite")
        if keep is not None:
            keep.update(dataset=ds, pipeline=pipe, grid=ex, steps=n_steps)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
