"""Training traffic: ``Trainer.step`` in a closed loop over epoch
permutations of a granule's ray set.

Set-up makes the granule from the seed, builds the program's dataset,
pipeline and Trainer, loads the benchmark's parameters, drives the Trainer
through its first ``update_every + 1`` steps (the compared ones: through
the first occupancy refresh and one step that samples from the refreshed
grid), warms up to a steady block time, and opens the window. The compared
steps start from an empty occupancy grid and take the benchmark's rows,
draws and refresh jitter (``inputs.Draws``); the warm-up, the window and
the profiled steps take the benchmark's rows and the Trainer's own random
streams, as a user's steps do. The window runs whole blocks of ``block``
steps until ``seconds`` have passed, and closes on a device
synchronisation.

The comparison, once the window has closed and the program's state is
freed: the reference rebuilds the rays from the granule, draws the same
parameters and follows the first three steps with the same rows and
draws. Compared are their losses, each leaf's first gradient as the
optimizer received it (from the program's first moment after step one)
and each leaf's change over the three steps, the norms by the worst leaf.
The refresh and the step after it are compared from the program's
parameters as the refresh read them: by step 16 two runs of the program
itself differ about as much as the program and the reference do (K2's
float atomics order the gradient's sums anew each run, and AdamW at eps
1e-15 turns a near-zero gradient's sign into a full step), which would
swamp a fault there. From those parameters the reference works the grid
out again (the density at every cell's jittered point, the decay) and
computes the next step's loss on it; compared are the grid and that
loss."""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import inputs, work
from perfbench.runners.common import (
    Clock, counter_delta, finite, free_device_memory, launch_counters, sync,
    worst_leaf_gap,
)
from perfbench.reference import ngp, scene
from perfbench.trace import profiled
from perfbench.warmup import warm_until_steady

CHANGE_STEPS = 3  # the leaves' change is compared over the first three steps
NEGLIGIBLE = 1e-3  # leaves whose reference gradient is below this share of the median leaf's


def _granule_arrays(granule: dict):
    from atmonr_tpu_torch.data.granule import GranuleArrays

    return GranuleArrays(**{k: granule[k] for k in GranuleArrays.__dataclass_fields__})


def run(run, seed: int, seconds: float, trace: bool, t0: float) -> None:
    from atmonr_tpu_torch import Trainer, get_pipeline
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset

    cfg, tr, dev = run.config, run.traffic, run.device
    clock = Clock(t0)
    granule = inputs.make_granule(tr["granule"], seed)
    t = clock.now()
    ds = HARP2Dataset(cfg["dataset"], _granule_arrays(granule), device=dev)
    run.spans["dataset_build_s"] = [clock.now() - t]
    pipe = get_pipeline(cfg["pipeline"], ds, device=dev)
    log_dir = tempfile.mkdtemp(prefix="perfbench-")
    trainer = Trainer(cfg["trainer"], ds, pipe, "perfbench", data_root=log_dir,
                      seed=inputs.stream_seed(seed, 5), device=dev)
    pipe.load_params(inputs.make_params(cfg["pipeline"], tr["params"], seed, dev))
    with torch.no_grad():
        # an empty occupancy grid (a grid of ones samples alike): the first
        # refresh then sets every cell to its density, where the ones'
        # decayed 0.8 would hide any density below it
        pipe.occ.zero_()
    batch = trainer.batch_size
    every = int(cfg["pipeline"]["occupancy"]["update_every"])
    feed = inputs.Draws(cfg["pipeline"], len(ds), batch, seed, dev)
    b1 = float(cfg["trainer"]["optimizer"]["betas"][0])

    checked, losses, program, refreshed = [], [], {}, {}
    for s in range(every + 1):
        rows, draws = feed.rows(), feed.draws()
        jitter = feed.jitter() if (trainer.iter_count + 1) % every == 0 else None
        losses.append(trainer.step(rows, draws, aux_jitter=jitter))
        with clock.excluded():
            # the reference's inputs wait on the host, out of the program's peak
            checked.append({"rows": rows.cpu(), "draws": {k: v.cpu() for k, v in draws.items()},
                            "jitter": None if jitter is None else jitter.cpu()})
            if s == 0:
                # the first moment after one step is (1 - b1) g; none where
                # the optimizer took no step
                state = trainer.optimizer.adamw.state
                program["g1"] = {
                    n: float(torch.linalg.vector_norm(state[p]["exp_avg"].double())) / (1 - b1)
                    if "exp_avg" in state.get(p, {}) else 0.0
                    for n, p in pipe.named_parameters()}
            if s == CHANGE_STEPS - 1:
                p3 = {n: p.detach().to("cpu", copy=True) for n, p in pipe.named_parameters()}
            if jitter is not None:
                # the grid the refresh made, and the parameters it read
                program["occ"] = pipe.occ.detach().to("cpu", copy=True)
                refreshed = {n: p.detach().to("cpu", copy=True)
                             for n, p in pipe.named_parameters()}
    program["losses"] = [float(x) for x in losses[:CHANGE_STEPS] + losses[-1:]]

    def one_step():
        return trainer.step(feed.rows())

    block = int(tr["block"])
    warm_until_steady(one_step, float, block=block, tol=float(tr["warmup_tol"]),
                      max_iters=int(tr["warmup_max_steps"]))
    sync(dev)
    run.setup_s = clock.now()

    before, it0 = launch_counters(), trainer.iter_count
    losses, blocks, cpu = [], [], []
    start, cpu0 = time.perf_counter(), time.thread_time()
    while True:
        for _ in range(block):
            losses.append(one_step())
        blocks.append(time.perf_counter())
        cpu.append(time.thread_time())
        if blocks[-1] - start >= seconds:
            break
    sync(dev)
    run.window_s = time.perf_counter() - start
    run.spans["block_s"] = list(np.diff([start] + blocks))
    run.spans["block_cpu_s"] = list(np.diff([cpu0] + cpu))
    steps = trainer.iter_count - it0
    refreshes = trainer.iter_count // every - it0 // every
    run.counters = counter_delta(before, launch_counters())
    run.work = {"steps": steps, "rays": steps * batch, "refreshes": refreshes,
                "flops": work.train_work(cfg["pipeline"], batch, steps, refreshes)["flops"]}
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.attempted = steps
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())

    if trace:
        n, it1 = int(tr["trace_steps"]), trainer.iter_count
        out = {}
        with profiled(dev, out):
            for _ in range(n):
                one_step()
        run.trace = out["trace"]
        run.traced = work.train_work(cfg["pipeline"], batch, n,
                                     trainer.iter_count // every - it1 // every)

    del trainer, pipe, ds, losses, one_step
    shutil.rmtree(log_dir, ignore_errors=True)
    free_device_memory()

    check_start = time.perf_counter()
    sc = scene.build_scene(granule, cfg["dataset"], dev)
    p0 = inputs.make_params(cfg["pipeline"], tr["params"], seed, dev)
    program["delta"] = {k: float(torch.linalg.vector_norm((p3[k] - p0[k].cpu()).double()))
                        for k in p3}
    del p3
    ref = reference_steps(cfg, sc, p0, checked, refreshed)
    run.readings = compare(program, ref)
    run.checks = dict(run.readings)
    run.spans["check_s"] = [time.perf_counter() - check_start]
    for variant in getattr(run, "variants", ()):
        # lower-precision controls and planted faults, for setting limits
        run.readings[variant] = compare(
            reference_steps(cfg, sc, p0, checked, refreshed, variant), ref)


def reference_steps(cfg: dict, sc, params: dict, checked: list, refreshed: dict,
                    variant: str | None = None) -> dict:
    """The reference's numbers on the checked rows, draws and refresh
    jitter. From ``params``, the first ``CHANGE_STEPS`` steps: each step's
    loss, the first gradient's leaf norms after the clip, and the leaves'
    change. From ``refreshed``, the program's parameters as the refresh
    read them: the occupancy grid after the refresh, and the loss of the
    step after it on that grid. ``variant`` puts a control or a fault in
    the reference's place: ``"table:<format>"`` keeps the tables in another
    format, ``"half_batch"`` takes the loss over the first half of each
    batch, ``"no_refresh"`` leaves the grid as it was."""
    parts = dict(part.split(":", 1) if ":" in part else (part, "")
                 for part in (variant or "").split("+") if part)
    model = ngp.Model(cfg["pipeline"], sc, table_format=parts.get("table"))
    dev = sc.rays["origin"].device

    def loss_of(p, c, occ):
        rows, draws = c["rows"].to(dev), {k: v.to(dev) for k, v in c["draws"].items()}
        if "half_batch" in parts:
            half = rows.shape[0] // 2
            rows = rows[:half]
            draws = {k: (v if k == "sr_noise" else v[:half]) for k, v in draws.items()}
        return model.loss(p, {k: v[rows] for k, v in sc.rays.items()}, draws, occ)

    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = ngp.AdamW(p, cfg["trainer"]["optimizer"])
    occ = torch.zeros(model.res, device=dev)
    out = {"losses": []}
    for s, c in enumerate(checked[:CHANGE_STEPS]):
        loss = loss_of(p, c, occ)
        grads = opt.clipped(dict(zip(p, torch.autograd.grad(loss, list(p.values())))))
        if s == 0:
            out["g1"] = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
        opt.step(grads)
        out["losses"].append(float(loss.detach()))
    with torch.no_grad():
        out["delta"] = {k: float(torch.linalg.vector_norm((p[k] - params[k]).double()))
                        for k in p}
        del p, opt
        at, after = checked[-2], checked[-1]
        p = {k: v.to(dev) for k, v in refreshed.items()}
        if "no_refresh" not in parts:
            occ = model.refresh(p, occ, at["jitter"].to(dev))
        out["occ"] = occ.cpu()
        out["losses"].append(float(loss_of(p, after, occ)))
    return out


def compare(program: dict, ref: dict) -> dict:
    """The compared numbers: the largest relative gap of the compared
    losses (the first steps' and the step's after the refresh), the worst
    leaf's gap in the first gradient's norm and in the change's norm, and
    the widest gap of the refreshed occupancy grid over the reference's
    largest cell. Leaves whose reference gradient is below ``NEGLIGIBLE``
    of the median leaf's move by round-off alone and are left out."""
    rel = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"])]
    med = float(np.median(list(ref["g1"].values())))
    leaves = [k for k, v in ref["g1"].items() if v >= NEGLIGIBLE * med]
    occ_gap = (program["occ"] - ref["occ"]).abs().max() / ref["occ"].abs().max()
    return {"loss_gap": finite(max(rel)),
            "grad_gap": finite(worst_leaf_gap(program["g1"], ref["g1"], leaves)),
            "update_gap": finite(worst_leaf_gap(program["delta"], ref["delta"], leaves)),
            "occ_gap": finite(float(occ_gap))}
