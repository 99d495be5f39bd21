"""Training traffic of the pair-bucket Instant-NGP: ``Trainer.step`` in a
closed loop over epoch permutations of a granule's ray set, with the
set-up, the compared steps, the warm-up, the window and the profiled steps
of ``train``'s runner, the program's spans recorded under the profiler
(``span_trace.profiled``; their summed counts kept as ``Run.span_counts``),
and the reference of ``reference/ngp_pb.py``.

The warm-up starts on a new epoch's rows, so that set-up draws one epoch
permutation beside the last, as every later epoch does: at about 1,780
steps an epoch, whether the window reaches an epoch's end depends on the
host's speed, and with it the peak, by 136 MB on an H100. Nothing of the
compared steps' rows is kept past them: a view of the first permutation
held to the run's end would make a window that reaches an epoch's end hold
three permutations where set-up held two.

The comparison differs from ``train``'s in one respect: each of the first
three steps is taken by the reference from the program's state before it
(its parameters and AdamW's moments), as the NeRF runner does, where
``train``'s reference follows its own trajectory from the first step's
parameters. On the pair-bucket grid that trajectory is chaotic within
three steps: AdamW at eps 1e-15 moves every table entry a step touches by
about the rate whatever its gradient's size, so an entry whose gradient
lies within rounding of zero (the sum of many points' weights in one
bucket) moves one way in the program and the other in the reference, and
the step after reads a feature 2 lr apart. So the followed trajectory's
loss and change gaps reach, on some seeds, the int8-table control's
(``PERF.md`` §2 gives the readings); from the program's state each step
differs by its own rounding only.

Compared, as ``train.compare`` compares them: the three steps' losses and
the loss of the step after the refresh; each leaf's first gradient (from
the program's first moment after step one) and its change over the three
steps, the program's against the sum of the reference's three steps; the
grid the step-16 refresh made, worked out by the reference from the
program's parameters as the refresh read them. The variants of ``train``
(``table:<format>``, ``half_batch``, ``no_refresh``) and ``hash:plain``,
the ordinary spatial hash on every hashed level, take the reference's
place from the same states."""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import inputs, work
from perfbench.reference import ngp_pb, scene
from perfbench.runners.common import (
    Clock, counter_delta, free_device_memory, launch_counters, sync,
)
from perfbench.runners.train import CHANGE_STEPS, _granule_arrays, compare
from perfbench.runners.train_nerf import adam_state
from perfbench.span_trace import profiled
from perfbench.warmup import warm_until_steady


def run(run, seed: int, seconds: float, trace: bool, t0: float) -> None:
    from atmonr_tpu_torch import Trainer, get_pipeline
    from atmonr_tpu_torch.data.harp2 import HARP2Dataset
    from atmonr_tpu_torch.utils import spans

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
        pipe.occ.zero_()  # an empty grid, as in ``train``: the first refresh sets every cell
    batch = trainer.batch_size
    every = int(cfg["pipeline"]["occupancy"]["update_every"])
    feed = inputs.Draws(cfg["pipeline"], len(ds), batch, seed, dev)
    adamw = trainer.optimizer.adamw
    b1 = float(cfg["trainer"]["optimizer"]["betas"][0])

    checked, losses, program, refreshed = [], [], {"states": []}, {}
    for s in range(every + 1):
        rows, draws = feed.rows(), feed.draws()
        jitter = feed.jitter() if (trainer.iter_count + 1) % every == 0 else None
        if s < CHANGE_STEPS:
            with clock.excluded():
                program["states"].append(adam_state(pipe, adamw))
        losses.append(trainer.step(rows, draws, aux_jitter=jitter))
        with clock.excluded():
            # the reference's inputs wait on the host, out of the program's peak
            checked.append({"rows": rows.cpu(), "draws": {k: v.cpu() for k, v in draws.items()},
                            "jitter": None if jitter is None else jitter.cpu()})
            if s == 0:
                # the first moment after one step is (1 - b1) g; none where
                # the optimizer took no step
                program["g1"] = {
                    n: float(torch.linalg.vector_norm(adamw.state[p]["exp_avg"].double())) / (1 - b1)
                    if "exp_avg" in adamw.state.get(p, {}) else 0.0
                    for n, p in pipe.named_parameters()}
            if s == CHANGE_STEPS - 1:
                p3 = {n: p.detach().to("cpu", copy=True) for n, p in pipe.named_parameters()}
            if jitter is not None:
                program["occ"] = pipe.occ.detach().to("cpu", copy=True)
                refreshed = {n: p.detach().to("cpu", copy=True)
                             for n, p in pipe.named_parameters()}
    program["losses"] = [float(x) for x in losses[:CHANGE_STEPS] + losses[-1:]]
    program["delta"] = {k: float(torch.linalg.vector_norm((p3[k] - program["states"][0][0][k])
                                                          .double())) for k in p3}
    del p3

    # the warm-up starts on a new epoch's rows: its permutation (117 MB of
    # int64 at 14.6 M rays) is drawn beside the last one in set-up, as at
    # every later epoch, so the peak holds one such draw whatever number of
    # steps the host's speed lets the window reach; the last compared rows
    # (a view) go first, or the first permutation would outlive its epoch
    del rows, draws, jitter
    while feed.step % feed.per_epoch:
        feed.rows()

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
        with spans.recording() as records, profiled(dev, out):
            for _ in range(n):
                one_step()
        run.trace = out["trace"]
        run.span_counts = {k: v["count"] for k, v in spans.summary(records).items()}
        run.traced = work.train_work(cfg["pipeline"], batch, n,
                                     trainer.iter_count // every - it1 // every)

    del trainer, pipe, ds, losses, one_step
    shutil.rmtree(log_dir, ignore_errors=True)
    free_device_memory()

    check_start = time.perf_counter()
    sc = scene.build_scene(granule, cfg["dataset"], dev)
    ref = hold(cfg, sc, program, checked, refreshed)
    run.readings = compare(program, ref)
    run.checks = dict(run.readings)
    run.spans["check_s"] = [time.perf_counter() - check_start]
    for variant in getattr(run, "variants", ()):
        # lower-precision controls and planted faults in the reference's
        # place, from the same states, for setting limits
        run.readings[variant] = compare(hold(cfg, sc, program, checked, refreshed, variant), ref)


def hold(cfg: dict, sc, program: dict, checked: list, refreshed: dict,
         variant: str | None = None) -> dict:
    """The reference's numbers on the checked rows, draws and refresh
    jitter. Each of the first ``CHANGE_STEPS`` steps from the program's
    state before it (``program["states"]``): its loss, the first step's
    gradient leaf norms, and the leaves' change, the norm of the sum of the
    three steps' updates. From ``refreshed``: the grid after the refresh
    and the loss of the step after it on that grid. ``variant``, a
    ``+``-joined list: ``"table:<format>"`` keeps the tables in another
    format, ``"hash:plain"`` indexes the hashed levels with the plain
    spatial hash, ``"half_batch"`` takes the loss over the first half of
    each batch, ``"no_refresh"`` leaves the grid as it was."""
    parts = dict(part.split(":", 1) if ":" in part else (part, "")
                 for part in (variant or "").split("+") if part)
    model = ngp_pb.Model(cfg["pipeline"], sc, table_format=parts.get("table"),
                         hashing="plain" if parts.get("hash") == "plain" else "pair_bucket")
    dev = sc.rays["origin"].device

    def loss_of(p, c, occ):
        rows, draws = c["rows"].to(dev), {k: v.to(dev) for k, v in c["draws"].items()}
        if "half_batch" in parts:
            half = rows.shape[0] // 2
            rows = rows[:half]
            draws = {k: (v if k == "sr_noise" else v[:half]) for k, v in draws.items()}
        return model.loss(p, {k: v[rows] for k, v in sc.rays.items()}, draws, occ)

    occ = torch.zeros(model.res, device=dev)
    out, delta = {"losses": []}, {}
    for s, c in enumerate(checked[:CHANGE_STEPS]):
        p0, m, v = ({k: x.to(dev) for k, x in part.items()} for part in program["states"][s])
        p = {k: x.clone().requires_grad_(True) for k, x in p0.items()}
        opt = ngp_pb.AdamW(p, cfg["trainer"]["optimizer"])
        opt.m, opt.v, opt.t = m, v, s
        loss = loss_of(p, c, occ)
        grads = opt.clipped(dict(zip(p, torch.autograd.grad(loss, list(p.values())))))
        if s == 0:
            out["g1"] = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
        opt.step(grads)
        out["losses"].append(float(loss.detach()))
        for k in p:
            delta[k] = delta.get(k, 0) + (p[k].detach() - p0[k])
        del p, opt, grads, loss
    with torch.no_grad():
        out["delta"] = {k: float(torch.linalg.vector_norm(d.double())) for k, d in delta.items()}
        del delta
        at, after = checked[-2], checked[-1]
        p = {k: v.to(dev) for k, v in refreshed.items()}
        if "no_refresh" not in parts:
            occ = model.refresh(p, occ, at["jitter"].to(dev))
        out["occ"] = occ.cpu()
        out["losses"].append(float(loss_of(p, after, occ)))
    return out
