"""NeRF training traffic: ``Trainer.step`` of the hierarchical NeRF in a
closed loop over epoch permutations of a granule's ray set.

Set-up makes the granule from the seed, builds the program's dataset,
pipeline (``get_pipeline`` -> ``NeRFPipeline``) and Trainer, loads the
benchmark's parameters through the pipeline's own loader, drives the
Trainer through ``compared_steps`` steps with the benchmark's rows and
draws (``inputs_nerf.Draws``), warms up to a steady block time, and opens
the window. The warm-up, the window and the profiled steps take the
benchmark's rows and the Trainer's own random streams, as a user's steps
do. The window runs whole blocks of ``block`` steps until ``seconds`` have
passed, and closes on a device synchronisation. With ``trace``, one more
block of steps runs under the profiler with the program's spans recorded
(``span_trace.profiled``).

The comparison, once the window has closed and the program's state is
freed: the reference (``reference/nerf.py``) rebuilds the rays from the
granule and takes each compared step from the program's state before it
(its parameters and Adam's moments), with the same rows and draws.
Compared are each step's loss, the first gradient as the optimizer
received it (from the program's first moment after step one), each leaf's
change over the compared steps (the program's against the sum of the
reference's steps), the leaves by the worst, and each step's fine depths.

Each step starts from the program's state because the trajectory is
chaotic: the fine depths invert the CDF of the coarse weights, and the
coarse MLP's gradient through them divides by a bin's probability; CUDA's
gathers sum that gradient with float atomics, so two runs of the program
itself differ in its last bits; Adam's first steps move every weight by
about lr whatever its gradient's size, so a weight whose gradient lies
within rounding of zero steps either way; and at encoding frequencies up
to 2^13 pi a depth that moves by a bin's 1e-5 turns a sample's encoding by
a visible angle. So two float32 trajectories part within a few steps,
while one step from one state agrees to rounding. For the same reason the
reference's fine pass runs at the program's fine depths, with its own
gradient through its own inverse CDF, and the depths are compared apart."""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import inputs, inputs_nerf, work_nerf
from perfbench.reference import nerf, scene
from perfbench.runners.common import (
    Clock, counter_delta, finite, free_device_memory, launch_counters, sync,
)
from perfbench.runners.train import _granule_arrays
from perfbench.span_trace import profiled
from perfbench.warmup import warm_until_steady

NEGLIGIBLE = 1e-3  # leaves whose reference gradient is below this share of the median leaf's


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
    pipe.load_params(inputs_nerf.make_params(cfg["pipeline"], seed, dev))
    batch = trainer.batch_size
    feed = inputs_nerf.Draws(cfg["pipeline"], len(ds), batch, seed, dev)
    b1 = trainer.optimizer.adamw.param_groups[0]["betas"][0]

    # the fine depths of each compared step, as the forward returned them
    depths = []
    hook = pipe.register_forward_hook(lambda m, args, out: depths.append(out["z_vals_fine"]))
    checked, losses, program = [], [], {"z": [], "states": []}
    for s in range(int(tr["compared_steps"])):
        rows, draws = feed.rows(), feed.draws()
        with clock.excluded():
            program["states"].append(adam_state(pipe, trainer.optimizer.adamw))
        losses.append(trainer.step(rows, draws))
        with clock.excluded():
            # the reference's inputs wait on the host, out of the program's peak
            checked.append({"rows": rows.cpu(), "draws": {k: v.cpu() for k, v in draws.items()}})
            program["z"].append(depths.pop().detach().cpu())
            if s == 0:
                # the first moment after one step is (1 - b1) g
                program["g1"] = {k: m / (1 - b1)
                                 for k, m in adam_state(pipe, trainer.optimizer.adamw)[1].items()}
    hook.remove()
    with clock.excluded():
        program["end"] = {n: p.detach().to("cpu", copy=True) for n, p in pipe.named_parameters()}
    program["losses"] = [float(x) for x in losses]

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
    run.counters = counter_delta(before, launch_counters())
    run.work = work_nerf.train_work(cfg["pipeline"], batch, steps)
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.attempted = steps
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())

    if trace:
        n = int(tr["trace_steps"])
        out = {}
        with spans.recording(), profiled(dev, out):
            for _ in range(n):
                one_step()
        run.trace = out["trace"]
        run.traced = work_nerf.train_work(cfg["pipeline"], batch, n)

    del trainer, pipe, ds, losses, one_step
    shutil.rmtree(log_dir, ignore_errors=True)
    free_device_memory()

    check_start = time.perf_counter()
    sc = scene.build_scene(granule, cfg["dataset"], dev)
    ref = hold(cfg, sc, program, checked)
    run.readings = compare(program, ref)
    run.checks = dict(run.readings)
    run.spans["check_s"] = [time.perf_counter() - check_start]
    for variant in getattr(run, "variants", ()):
        # lower-precision controls and planted faults in the program's
        # place, from its first state, held to the reference from their own
        as_program = follow(cfg, sc, program["states"][0][0], checked, variant)
        run.readings[variant] = compare(as_program, hold(cfg, sc, as_program, checked))


def adam_state(pipe, adamw) -> tuple[dict, dict, dict]:
    """Host copies of the parameters and of Adam's moments by name (zeros
    before the first step)."""
    p, m, v = {}, {}, {}
    for n, x in pipe.named_parameters():
        st = adamw.state.get(x, {})
        p[n] = x.detach().to("cpu", copy=True)
        m[n], v[n] = (st[k].to("cpu", copy=True) if k in st else torch.zeros_like(p[n])
                      for k in ("exp_avg", "exp_avg_sq"))
    return p, m, v


def _step_inputs(c: dict, sc, dev):
    rows, draws = c["rows"].to(dev), {k: v.to(dev) for k, v in c["draws"].items()}
    return {k: v[rows] for k, v in sc.rays.items()}, draws


def hold(cfg: dict, sc, program: dict, checked: list) -> dict:
    """The reference's numbers, each compared step taken from the
    program's state before it (``program["states"]``: parameters and
    Adam's moments) at the program's fine depths: each step's loss and own
    fine depths, the first gradient, and the leaves' change, the sum of the
    steps' updates."""
    model = nerf.Model(cfg["pipeline"], sc)
    dev = sc.rays["origin"].device
    schedule = nerf.lr_schedule(cfg["trainer"], sc.rays["origin"].shape[0])
    out = {"losses": [], "z": [], "delta": {}}
    for s, c in enumerate(checked):
        p0, m, v = ({k: x.to(dev) for k, x in part.items()} for part in program["states"][s])
        p = {k: x.clone().requires_grad_(True) for k, x in p0.items()}
        opt = nerf.Adam(p, schedule, m=m, v=v, t=s)
        rays, draws = _step_inputs(c, sc, dev)
        loss, grads, own = model.loss_and_grads(p, rays, draws, program["z"][s].to(dev))
        if s == 0:
            out["g1"] = {k: g.cpu() for k, g in grads.items()}
        opt.step(grads)
        out["losses"].append(float(loss))
        out["z"].append(own.cpu())
        for k in p:
            out["delta"][k] = out["delta"].get(k, 0) + (p[k].detach() - p0[k]).cpu()
    return out


def follow(cfg: dict, sc, params: dict, checked: list, variant: str) -> dict:
    """A control or a fault in the program's place, from ``params`` on its
    own trajectory over the checked rows and draws, recorded as the
    program is: ``"tf32"`` or ``"bf16"`` computes the products in that
    precision, ``"half_batch"`` takes the loss over the first half of each
    batch, ``"coarse_only"`` leaves the fine pass out of the loss."""
    model = nerf.Model(cfg["pipeline"], sc, gemm=variant if variant in ("tf32", "bf16") else None)
    dev = sc.rays["origin"].device
    p = {k: v.detach().to(dev, copy=True).requires_grad_(True) for k, v in params.items()}
    opt = nerf.Adam(p, nerf.lr_schedule(cfg["trainer"], sc.rays["origin"].shape[0]))
    terms = nerf.MODELS[:1] if variant == "coarse_only" else nerf.MODELS
    out = {"losses": [], "z": [], "states": []}
    for s, c in enumerate(checked):
        out["states"].append(tuple({k: x.detach().to("cpu", copy=True) for k, x in d.items()}
                                   for d in (p, opt.m, opt.v)))
        rays, draws = _step_inputs(c, sc, dev)
        rows = c["rows"].shape[0] // 2 if variant == "half_batch" else None
        loss, grads, own = model.loss_and_grads(p, rays, draws, None, terms, rows)
        opt.step(grads)
        if s == 0:
            out["g1"] = {k: m.cpu() / (1 - opt.b1) for k, m in opt.m.items()}
        out["losses"].append(float(loss))
        out["z"].append(own.cpu())
    out["end"] = {k: v.detach().cpu() for k, v in p.items()}
    return out


def _worst_leaf(program: dict, reference: dict, leaves, ord: int) -> float:
    """max over ``leaves`` of the ``ord``-norm of the program's leaf less
    the reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    norm = {k: float(torch.linalg.vector_norm(reference[k].double(), ord)) for k in leaves}
    med = float(np.median(list(norm.values())))
    return max(float(torch.linalg.vector_norm((program[k] - reference[k]).double(), ord))
               / max(norm[k], med) for k in leaves)


def compare(program: dict, ref: dict) -> dict:
    """The compared numbers: the largest relative gap of the steps' losses;
    the worst leaf's gap in the first gradient (the norm of the difference)
    and in the change over the steps (its L1 norm: Adam's first steps move
    every weight by about lr, so a weight whose gradient lies within
    rounding of zero steps either way, and the L1 norm counts such a weight
    by its share of the leaf, where the L2 norm of one such weight's 2 lr
    among a 256 x 256 leaf's 3 lr steps already reads 2.6e-3); the largest
    gap of a step's fine depths, the norm of the difference over the
    reference's. Leaves whose reference gradient is below ``NEGLIGIBLE`` of
    the median leaf's move by round-off alone and are left out."""
    rel = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"])]
    g_norm = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref["g1"].items()}
    med = float(np.median(list(g_norm.values())))
    leaves = [k for k, v in g_norm.items() if v >= NEGLIGIBLE * med]
    delta = {k: program["end"][k] - program["states"][0][0][k] for k in leaves}
    depth = [float(torch.linalg.vector_norm((a - b).double())
                   / torch.linalg.vector_norm(b.double()))
             for a, b in zip(program["z"], ref["z"])]
    return {"loss_gap": finite(max(rel)),
            "grad_gap": finite(_worst_leaf(program["g1"], ref["g1"], leaves, 2)),
            "update_gap": finite(_worst_leaf(delta, ref["delta"], leaves, 1)),
            "depth_gap": finite(max(depth))}
