"""Quality A/B at REAL-GRANULE scale: the counterpart of the JAX repo's
``tools/quality_real_scale.py``.

The matched-wall-clock protocol of ``quality_matrix`` on one real-schema
granule of 457x457 pixels x 90 views (~14.6 M rays at the configs' 45
degree view filter, all resident on the device): one dataset, built once
and shared by every cell; each cell trains a variant for the same seconds
and scores deterministic PSNR/SSIM over ALL rays. The scene is the
multi-scale broken-cloud field, 4,000 cells of at most 0.15 of the swath
and sensor noise 0.002, so that structure, not noise, limits the score.

``source=file`` (default) writes the granule once, cached under the
temporary directory as ``qrs_granule_<tag>/HARP2/``, and reads it through
the production reader (h5py); ``source=memory`` builds the same arrays with
no file (where h5py is not installed). Results stream to a JSONL
(resumable: a cell already there, keyed by name, seed and scene, is
skipped), each row with the device it ran on; the summary prints at the
end. The default ``out`` is ``results/quality_real_scale.jsonl`` under the
repo root (gitignored).

    python -m atmonr_tpu_torch.tools.quality_real_scale [budget=300] [seeds=0,1,2]
        [height=457] [width=457] [blobs=4000] [blob_max=0.15] [noise=0.002]
        [variants=...] [out=...] [source=file|memory]
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch

from atmonr_tpu_torch.tools import REPO, repo_path
from atmonr_tpu_torch.tools.ab_importance import BATCH_SIZE, run
from atmonr_tpu_torch.tools.quality_matrix import summary
from atmonr_tpu_torch.tools.real_scale_demo import load_real_scale

VARIANTS = {
    "uniform128": "configs/instant_ngp_tpu.json",
    "occ13_32p24f": "configs/instant_ngp_tpu_occ13.json",
    "occ13_q8": "configs/instant_ngp_tpu_occ13_q8.json",
    "occ13_q8sr": "configs/instant_ngp_tpu_occ13_q8sr.json",
    "occ21": "configs/instant_ngp_occ21.json",
    "occ21_pb": "configs/instant_ngp_occ21_pb.json",
}
MAX_ITERS = 500_000  # the wall-clock budget is the real stop
OUT = REPO / "results" / "quality_real_scale.jsonl"


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         max_iters: int = MAX_ITERS, batch_size: int = BATCH_SIZE) -> list[dict]:
    """Runs the cells not yet in ``out`` on ``device`` (``cuda`` unless
    given) and returns every row of ``out`` for this scene and the chosen
    variants."""
    from atmonr_tpu_torch import load_config
    from atmonr_tpu_torch.utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    budget = 300.0
    seeds = [0, 1, 2]
    height = width = 457
    blobs, blob_max, noise = 4000, 0.15, 0.002  # ~34 px max cell width at 457
    out_path = OUT
    names = list(VARIANTS)
    source = "file"
    for a in argv:
        k, _, v = a.partition("=")
        if k == "budget":
            budget = float(v)
        elif k == "seeds":
            seeds = [int(s) for s in v.split(",")]
        elif k == "height":
            height = int(v)
        elif k == "width":
            width = int(v)
        elif k == "blobs":
            blobs = int(v)
        elif k == "blob_max":
            blob_max = float(v)
        elif k == "noise":
            noise = float(v)
        elif k == "out":
            out_path = Path(v)
        elif k == "variants":
            names = v.split(",")
        elif k == "source":
            source = v

    dev = resolve_device(device)
    scene_tag = f"real_scale_{height}x{width}_b{blobs}_w{blob_max:g}_n{noise:g}"
    done = set()
    if out_path.exists():
        for line in out_path.read_text().splitlines():
            r = json.loads(line)
            done.add((r["name"], r["seed"], r["scene"]))
    out_path.parent.mkdir(parents=True, exist_ok=True)

    # one granule and dataset, shared by every cell (the variants' dataset
    # sections are identical; asserted)
    cfgs = {n: load_config(repo_path(VARIANTS[n])) for n in names}
    ds_cfgs = [json.dumps(c["dataset"], sort_keys=True) for c in cfgs.values()]
    if len(set(ds_cfgs)) != 1:
        raise ValueError("variants disagree on the dataset config")
    cache = Path(tempfile.gettempdir()) / f"qrs_granule_{scene_tag}"
    ds, timings = load_real_scale(next(iter(cfgs.values()))["dataset"], source, dev, cache,
                                  height, width, n_blobs=blobs, blob_max=blob_max,
                                  noise=noise)
    if timings["granule_s"] is not None:
        print(f"[granule {'written' if source == 'file' else 'built'} in "
              f"{timings['granule_s']:.1f}s]", flush=True)
    print(f"[dataset: {ds.num_rays / 1e6:.1f} M rays built in "
          f"{timings['dataset_build_s']:.1f}s]", flush=True)

    with open(out_path, "a") as f:
        for name in names:
            for seed in seeds:
                if (name, seed, scene_tag) in done:
                    continue
                r = run(name, VARIANTS[name], max_iters, seed=seed, seconds=budget, dataset=ds,
                        batch_size=batch_size)
                r["scene"] = scene_tag
                r["budget_s"] = budget
                r["num_rays"] = int(ds.num_rays)
                f.write(json.dumps(r) + "\n")
                f.flush()

    rows = [json.loads(ln) for ln in out_path.read_text().splitlines()]
    rows = [r for r in rows if r["scene"] == scene_tag and r["name"] in names]
    summary(rows, names, [("", lambda r: True)],
            f"\n== real-granule scale, {budget:.0f}s/cell, seeds {seeds} ==")
    return rows


if __name__ == "__main__":
    main()
