"""Reproduce and diagnose the branch collapse of an Instant-NGP cell: the
counterpart of the JAX repo's ``tools/repro_occ15_collapse.py``.

A collapsed cell renders a constant image: its loss pins at ~1.5-1.8 and
its SSIM at ~0.75. It is decided in the first steps: the surface branch
takes the scene mean, and the atmosphere branch (position table, density
and color MLPs) dies with exactly zero gradient. This tool trains cells of
one config on the 96x48-pixel synthetic scene with a loss / global
gradient norm / ``pmax`` trace every 25 steps, the per-branch gradient
norms of the first 20 steps, the outcome by the restart guard's rule, and
the JAX tool's deterministic eval:

    python -m atmonr_tpu_torch.tools.repro_occ15_collapse [mode=baseline|clip|eps|lr]
        [iters=925] [seed=2 | seeds=0-31] [config=configs/instant_ngp_tpu_occ.json]
        [init=port|jax] [products=bf16|bf16_f32reduce|f32] [scene=smooth|hard] [seconds=S]
        [gemms=1] [out=results/repro_occ15_collapse.jsonl]

    baseline  the cell as configured
    clip      + the global-norm clip at 1.0 before AdamW
    eps       AdamW eps -> 1e-8
    lr        lr -> 3e-3

- ``init``: ``port`` draws the parameters from this package's generator
  (seed ``1000 * seed``, as ``ab_importance.run``); ``jax`` takes the JAX
  package's ``init_params(PRNGKey(1000 * seed))`` bit for bit
  (``convert.jax_ngp_init``). The draws and the permutations come from the
  device generators of ``ab_importance.run`` either way.
- ``products``: the MLP products in ``bf16`` as the pipeline runs them
  (PyTorch's default lets cuBLAS reduce split-K partial sums in bf16),
  ``bf16_f32reduce`` (bf16 with
  ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  off: float32 reduction), or ``f32`` (float32 products, TF32 off).
- ``seconds``: train for a wall-clock budget (clock read after a sync every
  25 steps, the first step outside it); ``iters`` becomes a cap.
- ``gemms=1`` profiles one train step and prints the matrix-product
  kernels it launched (cuBLAS picks split-K by a heuristic).

The step and the streams are ``ab_importance.run``'s (``bench.make_train_step``:
the occupancy refresh after every ``update_every``-th step, one more after
the first step). A cell's outcome is the guard's (``restart_on_plateau``):
collapsed when the mean of the last 5 losses at step 150 exceeds 1.0.
Rows append to ``out`` (JSONL, each with the device's name and power
limit); with several seeds the run ends with its collapse count and the
Clopper-Pearson 95% interval. A sweep of several ``init`` and ``products``
arms is one call an arm: each cell builds its own pipeline and generators.
Runs on ``cuda`` unless ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from atmonr_tpu_torch.tools import REPO, repo_path

MODES = ("baseline", "clip", "eps", "lr")
INITS = ("port", "jax")
PRODUCTS = ("bf16", "bf16_f32reduce", "f32")
BRANCHES = ("pos_table", "pos_mlp", "dir_mlp", "surf_enc", "surf_mlp")  # 3 atmosphere, 2 surface
GRANULE = {"height": 96, "width": 48, "views_per_band": 2}
SCENES = {"smooth": 1, "hard": 40}
BATCH_SIZE = 8192
TRACE_EVERY = 25
BRANCH_STEPS = 20
CHECK_ITER, THRESHOLD, WINDOW = 150, 1.0, 5
OUT = REPO / "results" / "repro_occ15_collapse.jsonl"


def parse_seeds(text: str) -> list[int]:
    """``"0-31"`` or ``"0,4,7"`` (ranges inclusive, mixable)."""
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds.extend(range(int(lo), int(hi or lo) + 1))
    return seeds


def clopper_pearson(k: int, n: int, level: float = 0.95) -> tuple[float, float]:
    """The exact binomial interval of a rate of ``k`` in ``n``."""
    a = (1.0 - level) / 2.0

    def solve(first: int, target: float) -> float:
        """The p at which P(X >= first) (rising in p) equals ``target``."""
        lo, hi = 0.0, 1.0
        for _ in range(60):
            mid = (lo + hi) / 2
            tail = sum(math.comb(n, j) * mid**j * (1 - mid) ** (n - j) for j in range(first, n + 1))
            lo, hi = (mid, hi) if tail < target else (lo, mid)
        return (lo + hi) / 2

    lower = 0.0 if k == 0 else solve(k, a)
    upper = 1.0 if k == n else solve(k + 1, 1.0 - a)
    return lower, upper


@contextlib.contextmanager
def products_setting(pipe, products: str):
    """The pipeline's MLP products for one arm, PyTorch's flags restored
    after."""
    if products not in PRODUCTS:
        raise ValueError(f"products must be one of {PRODUCTS}, not {products!r}")
    mm = torch.backends.cuda.matmul
    saved = (pipe.compute_dtype, mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32)
    pipe.compute_dtype = torch.float32 if products == "f32" else torch.bfloat16
    mm.allow_bf16_reduced_precision_reduction = products == "bf16"
    mm.allow_tf32 = False
    try:
        yield
    finally:
        pipe.compute_dtype = saved[0]
        mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32 = saved[1:]


def outcome(losses: np.ndarray, branch_norms: np.ndarray) -> dict:
    """The guard's verdict on one cell from its per-step losses and (steps,
    5) branch gradient norms: the mean of the last ``WINDOW`` losses at
    ``CHECK_ITER`` and at the end, each against ``THRESHOLD``; the first
    step (1-based) from which that mean stays above it to the end; and the
    first step from which each branch's gradient stays exactly zero."""
    n = len(losses)
    # means[j]: the mean of steps j+1 .. j+WINDOW (1-based)
    means = np.convolve(losses, np.ones(WINDOW) / WINDOW, "valid") if n >= WINDOW else np.zeros(0)
    at_check = float(means[CHECK_ITER - WINDOW]) if n >= CHECK_ITER else None
    above = means > THRESHOLD
    pinned_from = None
    if len(above) and above[-1]:
        first = len(above) - int(np.argmin(above[::-1])) if not above.all() else 0
        pinned_from = first + WINDOW

    def dead_from(norm: np.ndarray):
        if norm[-1] != 0:
            return None
        live = np.nonzero(norm)[0]
        return int(live[-1]) + 2 if len(live) else 1

    atmo = np.sqrt((branch_norms[:, :3] ** 2).sum(1))
    surf = np.sqrt((branch_norms[:, 3:] ** 2).sum(1))
    return {
        "loss_at_check": at_check,
        "collapsed_at_check": None if at_check is None else at_check > THRESHOLD,
        "loss_last": float(means[-1]) if len(means) else float(np.mean(losses)),
        "collapsed": bool(above[-1]) if len(above) else None,
        "pinned_from": pinned_from,
        "atmosphere_dead_from": dead_from(atmo),
        "surface_dead_from": dead_from(surf),
    }


def _optimizer_config(cfg: dict, mode: str) -> dict:
    opt = dict(cfg["trainer"]["optimizer"])
    if mode == "clip":
        opt["clip_global_norm"] = 1.0
    elif mode == "eps":
        opt["eps"] = 1e-8
    elif mode == "lr":
        opt["lr"] = 3e-3
    elif mode != "baseline":
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    return opt


class _Cell:
    """One cell's pipeline, optimizer, streams and step."""

    def __init__(self, cfg: dict, dataset, seed: int, init: str, mode: str,
                 batch_size: int, device: torch.device) -> None:
        from atmonr_tpu_torch import convert, get_pipeline
        from atmonr_tpu_torch.data.batching import epoch_permutation

        if init not in INITS:
            raise ValueError(f"init must be one of {INITS}, not {init!r}")
        self.pipe = pipe = get_pipeline(cfg["pipeline"], dataset, device=device,
                                        generator=torch.Generator().manual_seed(1000 * seed))
        if init == "jax":
            pipe.load_params(convert.params_from_jax(convert.jax_ngp_init(cfg["pipeline"], 1000 * seed)))
        opt_cfg = _optimizer_config(cfg, mode)
        self.opt = pipe.make_optimizer(opt_cfg, float(opt_cfg["lr"]))
        self.rays = dataset.rays(device)
        self.b = min(batch_size, dataset.num_rays)
        self.n_rays = dataset.num_rays
        self.steps_per_epoch = max(1, dataset.num_rays // self.b)
        self.draws_gen = torch.Generator(device=device).manual_seed(1000 * seed + 1)
        self.perm_gen = torch.Generator(device=device).manual_seed(1000 * seed + 2)
        self.perm = epoch_permutation(self.perm_gen, dataset.num_rays, self.b)
        self.every = pipe.occ_cfg.update_every if pipe.occ_cfg is not None else 0
        named = list(pipe.named_parameters())
        self.params = [p for _, p in named]
        self.group = torch.tensor([BRANCHES.index(n.split(".")[0]) for n, _ in named], device=device)

    def step(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Train step ``i``: (loss, the five branch gradient norms before the
        clip), both on the device."""
        from atmonr_tpu_torch.data.batching import batch_at_step, epoch_permutation

        pipe = self.pipe
        batch = batch_at_step(self.rays, self.perm, i % self.steps_per_epoch, self.b)
        draws = pipe.make_draws(self.b, self.draws_gen)
        self.opt.zero_grad()
        loss = pipe.compute_loss(batch, pipe(batch, draws=draws))
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        norms = torch.zeros(len(BRANCHES), device=sq.device).index_add_(0, self.group, sq).sqrt()
        self.opt.step()
        if self.every and ((i + 1) % self.every == 0 or i == 0):
            pipe.update_aux(generator=self.draws_gen)
        if (i + 1) % self.steps_per_epoch == 0:
            self.perm.copy_(epoch_permutation(self.perm_gen, self.n_rays, self.b))
        return loss.detach(), norms

    def pmax(self) -> torch.Tensor:
        return torch.maximum(self.pipe.pos_table.detach().abs().max(),
                             self.pipe.pos_mlp.layers[0].weight.detach().abs().max())


def gemm_kernels(cell: _Cell, products: str) -> list[tuple[str, int, float]]:
    """(kernel name, calls, device us) of the matrix-product kernels of one
    train step under ``products``: the names say whether cuBLAS split K."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.pipe.device.type == "cuda" else [])
    with products_setting(cell.pipe, products):
        cell.step(0)
        with profile(activities=acts) as prof:
            cell.step(1)
            if cell.pipe.device.type == "cuda":
                torch.cuda.synchronize()
    words = ("gemm", "splitk", "split_k", "reduce_kernel", "xmma", "cutlass", "matmul", "addmm", "mm")
    rows = []
    for e in prof.key_averages():
        name = e.key.lower()
        if any(w in name for w in words) and "norm" not in name:
            us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            rows.append((e.key, int(e.count), float(us)))
    return sorted(rows, key=lambda r: -r[2])


def run_cell(cfg: dict, dataset, seed: int, *, init: str = "port", products: str = "bf16",
             mode: str = "baseline", num_iters: int = 925, seconds: float | None = None,
             batch_size: int = BATCH_SIZE, device: torch.device) -> dict:
    """Train one cell and return its row (``outcome``'s keys, the trace, the
    branch norms of the first ``BRANCH_STEPS`` steps, PSNR/SSIM)."""
    from atmonr_tpu_torch.tools.ab_importance import evaluate as score

    cell = _Cell(cfg, dataset, seed, init, mode, batch_size, device)
    tag = f"[{mode} seed={seed} init={init} products={products}]"
    losses = torch.zeros(num_iters, device=device)
    norms = torch.zeros((num_iters, len(BRANCHES)), device=device)
    trace, lo = [], float("inf")
    with products_setting(cell.pipe, products):
        t0 = time.perf_counter()
        i = 0
        while i < num_iters:
            losses[i], norms[i] = cell.step(i)
            if i == 0:
                float(losses[0])  # the kernels' first build stays outside the clock
                t0 = time.perf_counter()
            if i % TRACE_EVERY == 0 or i == num_iters - 1:
                l, g, p = (float(v) for v in (losses[i], norms[i].square().sum().sqrt(), cell.pmax()))
                lo = min(lo, l)
                flag = "  <-- SPIKE" if l > 10 * lo and l > 1e-3 else ""
                print(f"iter {i:5d} loss {l:10.5f} gnorm {g:10.3f} pmax {p:8.3f}{flag}", flush=True)
                trace.append([i, l, g, p])
                if seconds is not None and i and time.perf_counter() - t0 >= seconds:
                    i += 1
                    break
            i += 1
        dt = time.perf_counter() - t0
        losses_h = losses[:i].cpu().numpy().astype(np.float64)
        norms_h = norms[:i].cpu().numpy().astype(np.float64)
        cell.opt = None
        cell.pipe.zero_grad(set_to_none=True)
        m = score(cell.pipe, dataset, cell.b)
    first = norms_h[:BRANCH_STEPS]
    print(f"{tag} branch gradient norms, steps 1-{len(first)} ("
          + ", ".join(BRANCHES) + "):", flush=True)
    for s, row in enumerate(first, 1):
        print(f"  step {s:3d} " + " ".join(f"{v:10.3e}" for v in row), flush=True)
    row = {"seed": seed, "init": init, "products": products, "mode": mode, "iters": i,
           "seconds": round(dt, 2), **outcome(losses_h, norms_h),
           "loss_first": float(losses_h[0]), "loss_final": float(losses_h[-1]),
           "trace": trace, "branch_norms": first.tolist(),
           "psnr": float(m["PSNR_mean"]), "ssim": float(m["SSIM_mean"])}
    verdict = {True: "collapsed", False: "healthy", None: "undecided"}[row["collapsed"]]
    dead = [f"{b} gradient 0 from step {row[f'{b}_dead_from']}" for b in ("atmosphere", "surface")
            if row[f"{b}_dead_from"] is not None]
    print(f"{tag} {i} iters ({dt:.1f}s) final loss={row['loss_final']:.5f} "
          f"loss@{CHECK_ITER}={row['loss_at_check'] if row['loss_at_check'] is None else round(row['loss_at_check'], 5)} "
          f"{verdict}" + (f" (5-loss mean above {THRESHOLD} from step {row['pinned_from']})"
                          if row["collapsed"] else "")
          + (f"; {'; '.join(dead)}" if dead else "")
          + f" PSNR={row['psnr']:.2f} SSIM={row['ssim']:.4f}", flush=True)
    return row


def _parse(argv: list[str]) -> dict:
    opts = {"mode": "baseline", "iters": 925, "seeds": [2], "config": "configs/instant_ngp_tpu_occ.json",
            "init": "port", "products": "bf16", "scene": "smooth", "seconds": None, "gemms": False,
            "out": OUT}
    for a in argv:
        k, _, v = a.partition("=")
        if k == "mode":
            opts["mode"] = v
        elif k == "iters":
            opts["iters"] = int(v)
        elif k in ("seed", "seeds"):
            opts["seeds"] = parse_seeds(v)
        elif k == "config":
            opts["config"] = v
        elif k in ("init", "products"):
            opts[k] = v
        elif k == "scene":
            opts["scene"] = v
        elif k == "seconds":
            opts["seconds"] = float(v)
        elif k == "gemms":
            opts["gemms"] = v not in ("0", "false")
        elif k == "out":
            opts["out"] = Path(v)
        else:
            raise ValueError(f"unknown argument {a!r}")
    if opts["init"] not in INITS or opts["products"] not in PRODUCTS:
        raise ValueError(f"init must be one of {INITS} and products one of {PRODUCTS}")
    if opts["mode"] not in MODES or opts["scene"] not in SCENES:
        raise ValueError(f"mode must be one of {MODES} and scene one of {tuple(SCENES)}")
    if opts["seconds"] is not None:
        opts["iters"] = max(opts["iters"], 200_000)
    return opts


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         granule: dict | None = None, batch_size: int = BATCH_SIZE) -> list[dict]:
    """Every seed of the arm; returns the rows. ``granule`` and
    ``batch_size`` shrink a CPU run."""
    from atmonr_tpu_torch import load_config
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
    from atmonr_tpu_torch.utils.device import describe_device, resolve_device

    opts = _parse(list(sys.argv[1:] if argv is None else argv))
    dev = resolve_device(device)
    name = describe_device(dev)
    cfg = load_config(repo_path(opts["config"]))
    dataset = HARP2Dataset(
        cfg["dataset"],
        make_synthetic_granule(**(granule or GRANULE), n_blobs=SCENES[opts["scene"]]),
        device=dev)
    print(f"[collapse] {opts['config']} on the {opts['scene']} scene ({dataset.num_rays} rays), "
          f"mode {opts['mode']}, {len(opts['seeds'])} seeds, on {name}", flush=True)
    out = Path(opts["out"])
    out.parent.mkdir(parents=True, exist_ok=True)
    init, products = opts["init"], opts["products"]
    if opts["gemms"]:
        cell = _Cell(cfg, dataset, 0, init, opts["mode"], batch_size, dev)
        print(f"[gemms] init={init} products={products}: matrix-product kernels of one step "
              "(name, calls, device us):", flush=True)
        for kname, calls, us in gemm_kernels(cell, products):
            print(f"  {kname[:160]} | {calls} | {us:.1f}", flush=True)
        del cell
    rows = []
    for seed in opts["seeds"]:
        row = run_cell(cfg, dataset, seed, init=init, products=products, mode=opts["mode"],
                       num_iters=opts["iters"], seconds=opts["seconds"],
                       batch_size=batch_size, device=dev)
        row.update(config=opts["config"], scene=opts["scene"], device=name)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        rows.append(row)
    checked = [r for r in rows if r["collapsed_at_check"] is not None]
    if len(checked) > 1:
        k = sum(r["collapsed_at_check"] for r in checked)
        lo, hi = clopper_pearson(k, len(checked))
        print(f"[sweep] init={init} products={products} mode={opts['mode']}: {k} of "
              f"{len(checked)} cells collapsed at step {CHECK_ITER} ({100 * k / len(checked):.1f}%, "
              f"95% interval {100 * lo:.1f}-{100 * hi:.1f}%); collapsed seeds "
              f"{[r['seed'] for r in checked if r['collapsed_at_check']]}, on {name}", flush=True)
    return rows


if __name__ == "__main__":
    main()
