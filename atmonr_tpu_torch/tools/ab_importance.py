"""Train one Instant-NGP variant, then score deterministic PSNR/SSIM over the
whole granule: the counterpart of the JAX repo's ``tools/ab_importance.py``,
the quality harness behind every knob of the flagship config.

``run`` trains a config for a number of iterations, or for a matched
wall-clock budget, on a synthetic granule (96x48 pixels, 2 views a band;
``n_blobs=40`` the hard scene) or a dataset the caller built, and scores the
deterministic forward over every ray. ``main`` compares three samplers at
3,000 iterations:

    python -m atmonr_tpu_torch.tools.ab_importance [hard] [name ...] [name=config.json ...]

Every result names the device it ran on (a card's name and power limit).
"""

from __future__ import annotations

import sys
import time

import torch

from atmonr_tpu_torch.tools import repo_path

VARIANTS = {
    "uniform128": "configs/instant_ngp_tpu.json",
    "importance32+32": "configs/instant_ngp_tpu_fast.json",
    "occ64p+32": "configs/instant_ngp_tpu_occ.json",
}
GRANULE = {"height": 96, "width": 48, "views_per_band": 2}
BATCH_SIZE = 8192
EVAL_SLICE = 4096
# under a wall-clock budget the clock is read, after a device sync, only at
# every SYNC_BLOCK-th step: a clock read without a sync measures the launch
# queue, and a sync every step would cost the host-bound step its overlap
SYNC_BLOCK = 25


@torch.no_grad()
def evaluate(pipe, dataset, batch_size: int = BATCH_SIZE) -> dict:
    """Deterministic PSNR/SSIM of ``pipe`` over every ray of ``dataset``.

    Slices of ``min(batch_size, EVAL_SLICE)`` rays through the
    deterministic forward without the occupancy grid (as the JAX tool's
    eval calls its forward without ``aux``: an occupancy config is scored
    on ``num_samples_per_ray`` uniform bins), each ray's color in its own
    band; the predictions stay on the device and come to the host once, for
    ``scatter_image`` and ``image_metrics`` against ``target_image``."""
    from atmonr_tpu_torch.training.metrics import image_metrics

    rays = dataset.rays(pipe.device)
    n = dataset.num_rays
    b = min(batch_size, EVAL_SLICE)
    preds = torch.empty(n, dtype=torch.float32, device=pipe.device)
    for s in range(0, n, b):
        sl = {k: v[s:s + b] for k, v in rays.items()}
        out = pipe(sl, use_grid=False)["color_map_fine"]
        preds[s:s + b] = torch.gather(out, 1, sl["irgb_idx"][:, None].long())[:, 0]
    pred_img = dataset.scatter_image(preds.cpu().numpy())
    return image_metrics(pred_img, dataset.target_image(), dataset.max_i)


def eval_slices(num_rays: int, batch_size: int = BATCH_SIZE) -> int:
    """The forwards of one ``evaluate`` over ``num_rays`` rays."""
    return -(-num_rays // min(batch_size, num_rays, EVAL_SLICE))


def run(
    name: str,
    path: str,
    num_iters: int,
    n_blobs: int = 1,
    seed: int = 0,
    seconds: float | None = None,
    dataset=None,
    *,
    device: str | torch.device | None = None,
    granule: dict | None = None,
    batch_size: int = BATCH_SIZE,
) -> dict:
    """Train one variant and score deterministic PSNR/SSIM.

    The step is ``Trainer.step`` of a ``Trainer`` of seed ``seed`` on the
    config's trainer block at ``batch_size`` rays and ``num_iters``
    iterations (its schedule, progress scatter and occupancy refresh after
    every ``update_every``-th step), on the rows ``Trainer.iterate`` would
    take (a new permutation every epoch), with the Trainer's
    ``restart_on_plateau`` guard after every step. The first step runs
    before the clock starts, so the kernels' first build stays out of it.

    ``seconds`` switches from matched iterations to MATCHED WALL-CLOCK:
    every ``SYNC_BLOCK`` steps the device is synced and the clock read, and
    training stops at the first block edge past the budget;
    ``num_iters`` becomes an upper bound. ``dataset`` injects a prebuilt
    ``HARP2Dataset`` (shared by many cells); by default the synthetic
    ``granule`` (``GRANULE``) with ``n_blobs`` is built on ``device``
    (``cuda`` unless given; raises when there is no card).

    Returns the JAX tool's keys (``name``, ``seed``, ``iters``, ``seconds``,
    ``rays_per_s``, ``loss``, ``psnr``, ``ssim``), ``restarts``, ``eval_s``
    (the eval's seconds, metrics included) and ``device`` (the card's name
    and power limit).
    """
    from atmonr_tpu_torch import get_pipeline, load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.tools import batches, tool_trainer
    from atmonr_tpu_torch.utils.device import describe_device, resolve_device

    cfg = load_config(repo_path(path))
    dev = resolve_device(device if dataset is None else dataset.device)
    if dataset is None:
        dataset = HARP2Dataset(
            cfg["dataset"], make_synthetic_granule(**(granule or GRANULE), n_blobs=n_blobs),
            device=dev)
    pipe = get_pipeline(cfg["pipeline"], dataset, device=dev)
    with tool_trainer(cfg["trainer"], dataset, pipe, name, seed, batch_size=batch_size,
                      num_iters=num_iters) as trainer:
        b = trainer.batch_size
        rows = batches(trainer)
        running, restarts = [], 0
        t0 = None
        while trainer.iter_count < num_iters:
            loss = trainer.step(next(rows))
            running = (running + [loss])[-trainer.print_frequency:]
            restarts += trainer.check_restart(running)
            if t0 is None:
                float(loss)
                t0 = time.perf_counter()
            elif seconds is not None and trainer.iter_count % SYNC_BLOCK == 0:
                float(loss)  # sync, so that the clock reads the work done
                if time.perf_counter() - t0 >= seconds:
                    break
        final_loss = float(loss)
        dt = time.perf_counter() - t0
        num_iters = trainer.iter_count
    # the Trainer (AdamW moments, progress pixels) is dead weight in the eval
    # (340 MB of moments at 2^21)
    del trainer
    pipe.zero_grad(set_to_none=True)
    t_eval = time.perf_counter()
    m = evaluate(pipe, dataset, b)
    eval_s = time.perf_counter() - t_eval
    print(
        f"[{name} seed={seed}] {num_iters} iters in {dt:.1f}s "
        f"({num_iters * b / dt:.0f} rays/s) loss={final_loss:.4f} "
        f"PSNR={m['PSNR_mean']:.3f} SSIM={m['SSIM_mean']:.4f}",
        flush=True,
    )
    return {
        "name": name,
        "seed": seed,
        "iters": int(num_iters),
        "seconds": round(dt, 2),
        "rays_per_s": round(num_iters * b / dt, 1),
        "loss": final_loss,
        "psnr": float(m["PSNR_mean"]),
        "ssim": float(m["SSIM_mean"]),
        "restarts": restarts,
        "eval_s": round(eval_s, 2),
        "device": describe_device(dev),
    }


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         num_iters: int = 3000, granule: dict | None = None,
         batch_size: int = BATCH_SIZE) -> list[dict]:
    """Each named variant (default: all three; ``name=config.json`` for an
    ad-hoc one) for ``num_iters`` iterations on the smooth scene, or with
    ``hard`` on the 40-blob scene. Returns the results."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n_blobs = 1
    if "hard" in argv:  # multi-scale broken-cloud scene (capacity matters)
        argv.remove("hard")
        n_blobs = 40
    out = []
    for name in argv or list(VARIANTS):
        if "=" in name:
            name, path = name.split("=", 1)
        else:
            path = VARIANTS[name]
        out.append(run(name, path, num_iters=num_iters, n_blobs=n_blobs, device=device,
                       granule=granule, batch_size=batch_size))
    return out


if __name__ == "__main__":
    main()
