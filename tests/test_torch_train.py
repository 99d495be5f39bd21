"""The port's train step against the JAX package, on the CPU: losses,
schedules, the clipped AdamW, batching, metrics, the gradients of one step of
a small Instant-NGP pipeline, a few ``Trainer`` steps against optax, and the
Trainer's own behaviour (micro-batches, restart, resume, SIGTERM, the CLI).

The small config is ``tests/test_torch_pipeline.py``'s (4 levels, 2^9
entries, 16-wide MLPs, 48 rays). Both packages get the same parameters
(``convert.params_from_jax``), the same index vectors and the same random
draws (made from JAX keys, passed to the port as tensors), float32 MLP
products unless a test says otherwise, and one float64 host preprocessor
(``_share_preprocessor``, see that file). With ``fwd_mode: "q8"`` the JAX
side calls the Pallas q8 kernel in interpret mode; its backward is, on the
CPU, JAX's exact f32 scatter.
"""

import copy
import json
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atmonr_tpu.data import batching as jbatching
from atmonr_tpu.models import hash_grid as jhg
from atmonr_tpu.ops import losses as jlosses
from atmonr_tpu.pipelines.instant_ngp import InstantNGPPipeline as JaxPipeline
from atmonr_tpu.training import metrics as jmetrics
from atmonr_tpu.training import schedules as jschedules
from atmonr_tpu_torch import Trainer, convert, get_dataset, get_pipeline
from atmonr_tpu_torch.data import batching as tbatching
from atmonr_tpu_torch.ops import losses as tlosses
from atmonr_tpu_torch.scripts import train as train_cli
from atmonr_tpu_torch.training import checkpoint as tckpt
from atmonr_tpu_torch.training import metrics as tmetrics
from atmonr_tpu_torch.training import optim as toptim
from atmonr_tpu_torch.training import schedules as tschedules
from test_torch_pipeline import (
    N_RAYS,
    SCENE,
    _config,
    _jax_dataset,
    _q8_dispatch,
    _share_preprocessor,
)

GOLDEN = np.load(Path(__file__).parent / "golden" / "ngp_pipeline.npz")
OPTIMIZER = {
    "lr": 0.01, "betas": [0.9, 0.99], "eps": 1e-15, "weight_decay": 0.01,
    "clip_global_norm": 1.0,
}
K_STEPS = 4


def _trainer_config(**over) -> dict:
    """The flagship's trainer block at a small size; the step-decay starts
    inside the first few steps and the grid refreshes every 2."""
    cfg = {
        "batch_size": N_RAYS, "num_iters": 40, "print_frequency": 2,
        "optimizer": dict(OPTIMIZER),
        "scheduler": {"type": "fixed", "gamma": 0.33, "decay_start": 2, "decay_interval": 1},
    }
    cfg.update(over)
    return cfg


def _small_config(mode: str = "q8", update_every: int = 2) -> dict:
    config = _config(mode)
    config["pipeline"]["occupancy"]["update_every"] = update_every
    return config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _jax_draws(key, jpipe, params, b):
    """The draws JAX's stochastic forward makes from ``key``."""
    key2, k_sr = jax.random.split(key)
    kp, kf = jax.random.split(key2)
    oc = jpipe.occ_cfg
    return {
        "sr_noise": jax.random.uniform(k_sr, params["pos_table"].shape),
        "probe": jax.random.uniform(kp, (b, oc.n_probe)),
        "fine": jax.random.uniform(kf, (b, oc.n_fine), maxval=1.0 / oc.n_fine),
    }


def _jax_loss_and_grads(jpipe, params, batch, key, aux):
    def loss_fn(p):
        return jpipe.compute_loss(batch, jpipe.forward(p, batch, key=key, aux=aux))

    return jax.value_and_grad(loss_fn)(params)


def _torch_loss_and_grads(tpipe, batch, draws):
    tpipe.zero_grad()
    loss = tpipe.compute_loss(batch, tpipe(batch, draws=draws))
    loss.backward()
    return loss.detach(), convert.grads_state(tpipe)


def _worst(got: dict, want: dict, rtol: float, atol_of_max: float) -> dict:
    """Per tensor, the largest excess of |got - want| over ``rtol * |want| +
    atol_of_max * max|want|`` (positive = outside the tolerance)."""
    assert got.keys() == want.keys()
    out = {}
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        assert g.shape == w.shape and np.all(np.isfinite(g)), k
        out[k] = float((np.abs(g - w) - rtol * np.abs(w) - atol_of_max * np.abs(w).max()).max())
    return out


# -- losses ---------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_losses_match_jax(name):
    """Values to rtol 1e-6, gradients to rtol 1e-5 plus 1e-7 of the largest
    (float32 log and divisions, means summed in another order)."""
    assert sorted(tlosses.LOSSES) == sorted(jlosses.LOSSES)
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.0, 0.3, 257).astype(np.float32)
    gt = rng.uniform(0.0, 0.3, 257).astype(np.float32)
    max_i = 0.37
    jval, jgrad = jax.value_and_grad(jlosses.get_loss(name))(
        jnp.asarray(pred), jnp.asarray(gt), max_i
    )
    tp = _t(pred).requires_grad_()
    tval = tlosses.get_loss(name.upper())(tp, _t(gt), max_i)
    (tgrad,) = torch.autograd.grad(tval, tp)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-5, atol=1e-7 * np.abs(jgrad).max())


# -- schedules, clip, AdamW -----------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 7], ids=["plain", "warmup"])
@pytest.mark.parametrize(
    "scheduler",
    [
        {"type": "fixed", "gamma": 0.33, "decay_start": 20, "decay_interval": 10},
        {"type": "fixed", "gamma": 0.5, "decay_start": 25, "decay_interval": 10},
        {"type": "target_lr", "final_lr": 1e-4},
    ],
    ids=["fixed", "fixed_offset", "target_lr"],
)
def test_schedules_match_jax(scheduler, warmup):
    """Step -> lr over a range that crosses ``decay_start`` and several
    epochs; rtol 1e-6 (JAX evaluates the power in float32)."""
    opt = dict(OPTIMIZER, warmup_iters=warmup)
    js = jschedules.apply_warmup(jschedules.make_lr_schedule(scheduler, opt, 60, 8), opt)
    ts = tschedules.apply_warmup(tschedules.make_lr_schedule(scheduler, opt, 60, 8), opt)
    for step in range(60):
        lr = ts(step)
        assert isinstance(lr, float)
        np.testing.assert_allclose(lr, float(js(jnp.asarray(step))), rtol=1e-6)
    assert ts(0) > ts(59)
    with pytest.raises(NotImplementedError):
        tschedules.make_lr_schedule({"type": "cosine"}, opt, 60, 8)


@pytest.mark.parametrize("norm", [0.5, 0.999, 1.001, 30.0])
def test_clip_matches_optax(norm):
    """``clip_by_global_norm``: untouched below ``max_norm``, else
    ``g / norm * max_norm``; rtol 1e-6 (the norm is summed in another
    order)."""
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in [(7, 3), (40,), (5, 5)]]
    total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    grads = [(g * (norm / total)).astype(np.float32) for g in grads]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [_t(g) for g in grads]
    before = toptim.clip_by_global_norm_(got, 1.0)
    np.testing.assert_allclose(float(before), norm, rtol=1e-5)
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        if norm < 1.0:
            np.testing.assert_array_equal(g.numpy(), orig)


def test_clipped_adamw_matches_optax():
    """Three updates of the chain ``clip -> adamw(schedule, mask)`` on two
    parameter groups with eps 1e-15: parameters to rtol 1e-5 plus 1e-7
    (every gradient element is far above eps, so no element's first update
    is ambiguous); rows with a zero gradient in the group without decay do
    not move."""
    rng = np.random.default_rng(2)
    w0 = rng.normal(size=(6, 4)).astype(np.float32)
    t0 = rng.uniform(-1e-4, 1e-4, (50, 2)).astype(np.float32)
    sched = {"type": "fixed", "gamma": 0.33, "decay_start": 1, "decay_interval": 1}
    jopt = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(
            learning_rate=jschedules.make_lr_schedule(sched, OPTIMIZER, 10, 5),
            b1=0.9, b2=0.99, eps=1e-15, weight_decay=0.01,
            mask={"w": True, "t": False},
        ),
    )
    jparams = {"w": jnp.asarray(w0), "t": jnp.asarray(t0)}
    jstate = jopt.init(jparams)
    w, t = torch.nn.Parameter(_t(w0)), torch.nn.Parameter(_t(t0))
    topt = toptim.ClippedAdamW(
        [w], [t], OPTIMIZER, tschedules.make_lr_schedule(sched, OPTIMIZER, 10, 5)
    )
    for step in range(3):
        gw = rng.normal(size=w0.shape).astype(np.float32) * (3.0 if step == 1 else 0.1)
        gt = rng.normal(size=t0.shape).astype(np.float32) * 0.1
        gt[10:30] = 0.0
        updates, jstate = jopt.update({"w": jnp.asarray(gw), "t": jnp.asarray(gt)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.zero_grad()
        w.grad, t.grad = _t(gw), _t(gt)
        topt.step()
    assert topt.count == 3
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jparams["w"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams["t"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(t.detach().numpy()[10:30], t0[10:30])
    state = topt.state_dict()
    topt2 = toptim.ClippedAdamW([w], [t], OPTIMIZER, 0.01)
    topt2.load_state_dict(state)
    assert topt2.count == 3


# -- batching and metrics ---------------------------------------------------------


def test_batching_matches_jax():
    rng = np.random.default_rng(3)
    rays = {"origin": rng.normal(size=(103, 3)).astype(np.float32),
            "rad": rng.uniform(size=103).astype(np.float32)}
    idx = rng.permutation(103)[:32]
    jb = jbatching.gather_batch({k: jnp.asarray(v) for k, v in rays.items()}, jnp.asarray(idx))
    tb = tbatching.gather_batch({k: _t(v) for k, v in rays.items()}, _t(idx))
    assert jb.keys() == tb.keys() and "idx" in tb
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    perm = _t(rng.permutation(103)[:96])
    step2 = tbatching.batch_at_step({k: _t(v) for k, v in rays.items()}, perm, 2, 32)
    np.testing.assert_array_equal(step2["idx"].numpy(), perm[64:96].numpy())
    np.testing.assert_array_equal(step2["rad"].numpy(), rays["rad"][perm[64:96].numpy()])
    for n, b in [(103, 32), (96, 32), (5, 8)]:
        for drop in (False, True):
            assert tbatching.num_batches(n, b, drop) == jbatching.num_batches(n, b, drop)
        np.testing.assert_array_equal(
            tbatching.sequential_indices(n, b).numpy(), np.asarray(jbatching.sequential_indices(n, b))
        )
        np.testing.assert_array_equal(
            tbatching.valid_mask(n, b).numpy(), np.asarray(jbatching.valid_mask(n, b))
        )


def test_epoch_permutation_drops_the_partial_batch():
    gen = torch.Generator().manual_seed(5)
    perm = tbatching.epoch_permutation(gen, 103, 32)
    assert perm.shape == (96,) and perm.dtype == torch.int64
    assert len(set(perm.tolist())) == 96 and 0 <= int(perm.min()) and int(perm.max()) < 103
    again = tbatching.epoch_permutation(torch.Generator().manual_seed(5), 103, 32)
    assert torch.equal(perm, again)
    assert not torch.equal(perm, tbatching.epoch_permutation(gen, 103, 32))


def test_image_metrics_match_jax():
    """The port's own copy of the numpy PSNR/SSIM: the same numbers."""
    rng = np.random.default_rng(4)
    target = rng.uniform(0, 0.3, (24, 20, 6)).astype(np.float32)
    pred = (target + rng.normal(0, 0.01, target.shape)).astype(np.float32)
    j = jmetrics.image_metrics(pred, target, 0.37)
    t = tmetrics.image_metrics(pred, target, 0.37)
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]), rtol=1e-6, err_msg=k)


# -- one step of the small pipeline -----------------------------------------------


@pytest.fixture(scope="module", params=["xla", "q8"])
def pair(request):
    """The JAX pipeline and the port's at identical parameters, with the
    occupancy grid refreshed once so that it is not flat."""
    mode = request.param
    config = _small_config(mode)
    with pytest.MonkeyPatch.context() as mp:
        if mode == "q8":
            mp.setattr(jhg, "_fwd_dispatch", _q8_dispatch)
        jds = _jax_dataset(config)
        jpipe = JaxPipeline(config["pipeline"], jds)
        jpipe.compute_dtype = jnp.float32
        params = jpipe.init_params(jax.random.PRNGKey(0))
        tds = get_dataset(config["dataset"], SCENE, device="cpu")
        tpipe = get_pipeline(copy.deepcopy(config["pipeline"]), tds, device="cpu")
        tpipe.compute_dtype = torch.float32
        tpipe.load_params(convert.params_from_jax(params))
        _share_preprocessor(jpipe, tpipe, jds.scene_transform)
        k_occ = jax.random.PRNGKey(1)
        aux = jpipe.update_aux(params, jpipe.init_aux(), k_occ)
        jitter = jax.random.uniform(k_occ, (jpipe.occ_cfg.num_cells, 3))
        tpipe.update_aux(jitter=_t(jitter))
        yield {"mode": mode, "config": config, "jds": jds, "jpipe": jpipe, "params": params,
               "tds": tds, "tpipe": tpipe, "aux": aux}


def _batches(tds, idx):
    rays = {k: v[idx] for k, v in tds.host_rays().items()}
    return {k: jnp.asarray(v) for k, v in rays.items()}, {k: _t(v) for k, v in rays.items()}


@pytest.fixture(scope="module")
def one_step(pair):
    """Loss and the 13 parameter gradients of one stochastic step, both
    packages, float32."""
    jpipe, tpipe, params = pair["jpipe"], pair["tpipe"], pair["params"]
    idx = np.random.default_rng(6).permutation(len(pair["tds"]))[:N_RAYS]
    jbatch, tbatch = _batches(pair["tds"], idx)
    key = jax.random.PRNGKey(2)
    draws = {k: _t(v) for k, v in _jax_draws(key, jpipe, params, N_RAYS).items()}
    jloss, jgrads = _jax_loss_and_grads(jpipe, params, jbatch, key, pair["aux"])
    tloss, tgrads = _torch_loss_and_grads(tpipe, tbatch, draws)
    jz = jpipe.forward(params, jbatch, key=key, aux=pair["aux"])["z_vals_fine"]
    with torch.no_grad():
        tz = tpipe(tbatch, draws=draws)["z_vals_fine"]
    return {"jloss": float(jloss), "tloss": float(tloss), "tgrads": tgrads,
            "jgrads": convert.params_from_jax(jgrads), "jz": np.asarray(jz), "tz": tz.numpy(),
            "tbatch": tbatch, "draws": draws}


def test_step_gradients_match_jax(pair, one_step):
    """All 13 gradients against ``jax.grad`` of the JAX pipeline. Every ray
    takes the same samples in both (checked first: the samplers are
    discontinuous). Tolerance per tensor: rtol 1e-4 plus 1e-5 of its largest
    value (float32 sums in another order through three MLPs, the compositor
    and the scatter; with ``"q8"`` also the one-ulp difference of ``pos``
    inside the interpret-mode forward, ``tests/test_torch_hash_grid.py::
    _pos_ulp_atol``, which reaches the MLP gradients through the features)."""
    np.testing.assert_allclose(one_step["tz"], one_step["jz"], rtol=1e-5)
    np.testing.assert_allclose(one_step["tloss"], one_step["jloss"], rtol=1e-5)
    tg, jg = one_step["tgrads"], one_step["jgrads"]
    assert len(jg) == 13 and set(jg) == set(dict(pair["tpipe"].named_parameters()))
    worst = _worst(tg, jg, rtol=1e-4, atol_of_max=1e-5)
    assert max(worst.values()) <= 0, worst
    for k in jg:
        assert float(jg[k].abs().max()) > 0, k


def test_step_gradient_ignores_the_rounding_noise(pair, one_step):
    """Straight through the quantizer: with other stochastic-rounding noise
    the forward changes (q8) and the table gradients' rows and weights do
    not: the same rows are touched."""
    tpipe = pair["tpipe"]
    draws = dict(one_step["draws"])
    draws["sr_noise"] = torch.rand(
        draws["sr_noise"].shape, generator=torch.Generator().manual_seed(9)
    )
    _, grads = _torch_loss_and_grads(tpipe, one_step["tbatch"], draws)
    touched = one_step["tgrads"]["pos_table"] != 0
    assert torch.equal(grads["pos_table"] != 0, touched) and bool(touched.any())
    if pair["mode"] == "xla":  # the exact path does not read the noise at all
        assert torch.equal(grads["pos_table"], one_step["tgrads"]["pos_table"])


def test_bf16_gradients_match_jax_bf16(pair, one_step):
    """bf16 MLP products (the default ``compute_dtype``). The two packages
    cast at the same places, so their bf16 gradients agree to 1e-5 of each
    tensor's largest value, like the float32 ones. Against the float32
    gradient the bf16 one is within 0.15 of the tensor's largest value
    (measured: up to 0.11 on the density MLP; 8 mantissa bits through up to
    four layers and their transposes), the stated cost of bf16 products."""
    jpipe, tpipe = pair["jpipe"], pair["tpipe"]
    idx = np.random.default_rng(6).permutation(len(pair["tds"]))[:N_RAYS]
    jbatch, tbatch = _batches(pair["tds"], idx)
    key = jax.random.PRNGKey(2)
    jpipe.compute_dtype, tpipe.compute_dtype = jnp.bfloat16, torch.bfloat16
    try:
        _, jgrads = _jax_loss_and_grads(jpipe, pair["params"], jbatch, key, pair["aux"])
        _, tgrads = _torch_loss_and_grads(tpipe, tbatch, one_step["draws"])
    finally:
        jpipe.compute_dtype, tpipe.compute_dtype = jnp.float32, torch.float32
    for t in tgrads.values():
        assert t.dtype == torch.float32
    worst = _worst(tgrads, convert.params_from_jax(jgrads), 0.0, 1e-5)
    assert max(worst.values()) <= 0, worst
    worst = _worst(tgrads, one_step["tgrads"], 0.0, 0.15)
    assert max(worst.values()) <= 0, worst
    assert not torch.equal(tgrads["pos_table"], one_step["tgrads"]["pos_table"])


# -- the golden oracle ---------------------------------------------------------------


class _GoldenDataset:
    scale = float(GOLDEN["scale"])
    offset = np.zeros(3)
    max_i = float(GOLDEN["max_i"])
    config = {"ray_origin_height": 20000}

    def get_point_preprocessor(self, kind):
        raise NotImplementedError


def test_golden_pipeline_loss_and_gradients():
    """``tests/golden/ngp_pipeline.npz`` (a recorded torch oracle of the tcnn
    semantics, as ``tests/test_ngp_parity.py`` uses it): renders, loss and
    the 13 gradients at that test's tolerances. The oracle samples 16
    uniform bin midpoints; the port has only the occupancy sampler, whose
    all-ones grid with 16 probes and 16 fine samples places the samples at
    the same midpoints, to rtol 1e-6."""
    from test_ngp_parity import CONFIG

    g = GOLDEN
    config = copy.deepcopy(CONFIG)
    config["occupancy"] = {"resolution": [4, 4, 4], "n_probe": 16, "n_fine": 16}
    pipe = get_pipeline(config, _GoldenDataset(), device="cpu")
    pipe.compute_dtype = torch.float32

    def mlp(name):
        n = sum(1 for k in g.files if k.startswith(f"w_{name}_"))
        return {"layers": [{"w": g[f"w_{name}_{i}"]} for i in range(n)]}

    pipe.load_params(convert.params_from_jax({
        "pos_table": g["pos_table"], "pos_mlp": mlp("pos_mlp"), "dir_mlp": mlp("dir_mlp"),
        "surf_enc": [{"hash_table": g["surf_table"]}, {}], "surf_mlp": mlp("surf_mlp"),
    }))
    batch = {k: _t(g[k]) for k in ("origin", "dir", "len", "rad")}
    batch["irgb_idx"] = _t(g["irgb_idx"].astype(np.int32))
    pipe.zero_grad()
    out = pipe(batch)
    loss = pipe.compute_loss(batch, out)
    loss.backward()
    np.testing.assert_allclose(out["z_vals_fine"].numpy(), g["z_vals_fine"], rtol=1e-6)
    for name in ("color_map_fine", "color_map_surf", "color_map_atmo"):
        np.testing.assert_allclose(
            out[name].detach().numpy(), g[name], rtol=2e-5, atol=2e-6, err_msg=name
        )
    np.testing.assert_allclose(
        out["weights_fine"].detach().numpy(), g["weights_fine"], rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(float(loss), float(g["loss"]), rtol=1e-5)
    grads = convert.grads_state(pipe)
    names = {"pos_table": "grad_pos_table", "surf_enc.0": "grad_surf_table"}
    for k in grads:
        if k not in names:
            mlp_name, _, i, _ = k.split(".")
            names[k] = f"grad_{mlp_name}_{i}"
    assert len(names) == 13 == sum(1 for k in g.files if k.startswith("grad_"))
    for k, gk in names.items():
        np.testing.assert_allclose(grads[k].numpy(), g[gk], rtol=3e-4, atol=2e-6, err_msg=k)


# -- a few Trainer steps against optax -------------------------------------------------


def _adam_state(opt_state):
    found = [
        s for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)
        ) if isinstance(s, optax.ScaleByAdamState)
    ]
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def training_run(pair, tmp_path_factory):
    """``K_STEPS`` steps of the port's ``Trainer`` and of a JAX loop (the JAX
    pipeline's ``make_optimizer``: optax clip + AdamW on the JAX schedule) on
    the same index vectors and draws, with two occupancy refreshes inside."""
    jpipe, params, tds = pair["jpipe"], pair["params"], pair["tds"]
    tcfg = _trainer_config()
    tpipe = get_pipeline(copy.deepcopy(pair["config"]["pipeline"]), tds, device="cpu")
    tpipe.compute_dtype = torch.float32
    tpipe.point_preprocessor = pair["tpipe"].point_preprocessor
    trainer = Trainer(tcfg, tds, tpipe, "parity", tmp_path_factory.mktemp("parity"), device="cpu")
    tpipe.load_params(convert.params_from_jax(params))
    assert trainer.batch_size == N_RAYS and trainer.aux_update_every == 2

    jopt = jpipe.make_optimizer(
        tcfg["optimizer"],
        jschedules.make_lr_schedule(
            tcfg["scheduler"], tcfg["optimizer"], tcfg["num_iters"], trainer.steps_per_epoch
        ),
    )
    opt_state = jopt.init(params)
    aux = jpipe.init_aux()
    jrays = {k: jnp.asarray(v) for k, v in tds.host_rays().items()}
    rng = np.random.default_rng(7)
    base, aux_key = jax.random.split(jax.random.PRNGKey(3))
    steps = []
    for s in range(K_STEPS):
        idx = rng.permutation(len(tds))[:N_RAYS]
        key = jax.random.fold_in(base, s)
        k_aux = jax.random.fold_in(aux_key, s + 1)
        jbatch = jbatching.gather_batch(jrays, jnp.asarray(idx))
        jloss, jgrads = _jax_loss_and_grads(jpipe, params, jbatch, key, aux)
        updates, opt_state = jopt.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if (s + 1) % 2 == 0:
            aux = jpipe.update_aux(params, aux, k_aux)
        draws = {k: _t(v) for k, v in _jax_draws(key, jpipe, pair["params"], N_RAYS).items()}
        jitter = _t(jax.random.uniform(k_aux, (jpipe.occ_cfg.num_cells, 3)))
        before = {k: v.detach().clone() for k, v in tpipe.named_parameters()}
        tloss = trainer.step(_t(idx), draws=draws, aux_jitter=jitter)
        mu, nu = convert.moments_state(tpipe, trainer.optimizer.adamw)
        adam = _adam_state(opt_state)
        steps.append({
            "jloss": float(jloss), "tloss": float(tloss),
            "jgrads": convert.params_from_jax(jgrads),
            "jparams": convert.params_from_jax(params),
            "tparams": {k: v.detach().clone() for k, v in tpipe.named_parameters()},
            "before": before,
            "jmu": convert.params_from_jax(adam.mu), "jnu": convert.params_from_jax(adam.nu),
            "tmu": mu, "tnu": nu,
            "jocc": np.asarray(aux["occ"]), "tocc": tpipe.occ.clone().numpy(),
            "idx": idx,
        })
    return {"steps": steps, "trainer": trainer}


def test_trainer_losses_match_jax(training_run):
    """Loss of every step to rtol 1e-4: from the second step on it is
    computed from parameters that each package updated itself."""
    for s in training_run["steps"]:
        assert np.isfinite(s["tloss"])
        np.testing.assert_allclose(s["tloss"], s["jloss"], rtol=1e-4)
    assert training_run["trainer"].iter_count == K_STEPS
    assert training_run["trainer"].optimizer.count == K_STEPS


def test_trainer_first_update_matches_jax(training_run):
    """After one step, under eps = 1e-15 (the update is ``lr * sign(g)`` for
    any |g| far above eps, so an element whose tiny gradient differs in sign
    between the packages moves by a full ``lr`` in opposite directions):
    parameters are compared where JAX's |g| exceeds 1e-4 of the tensor's
    largest, to rtol 1e-4 plus 1e-6 of the largest parameter; hash rows with
    a zero gradient do not move at all; MLP elements with a zero gradient
    only decay."""
    s = training_run["steps"][0]
    lr, wd = OPTIMIZER["lr"], OPTIMIZER["weight_decay"]
    for k, jp in s["jparams"].items():
        g = s["jgrads"][k]
        clear = g.abs() > 1e-4 * g.abs().max()
        assert float(clear.float().mean()) > 0.05, k
        tp, before = s["tparams"][k], s["before"][k]
        tol = 1e-4 * jp.abs() + 1e-6 * jp.abs().max()
        assert bool(((tp - jp).abs() <= tol)[clear].all()), k
        still = s["tmu"][k] == 0
        if k == "pos_table" or k.startswith("surf_enc"):
            assert bool(still.any()), k
            assert torch.equal(tp[still], before[still]), k
        elif bool(still.any()):
            torch.testing.assert_close(tp[still], before[still] * (1 - lr * wd), rtol=1e-6, atol=0)
        # a first update is one lr per element, whatever the gradient's size
        moved = (tp - before).abs()[clear]
        np.testing.assert_allclose(moved.max().item(), lr, rtol=2e-2)


def test_trainer_moments_match_jax(pair, training_run):
    """AdamW's moments after every step (both packages clip first, so the
    clip is inside), per tensor: ``mu`` to rtol 1e-3 plus ``a`` of its
    largest value, ``nu`` to rtol 2e-3 plus ``a`` of its largest, with
    ``a`` = 1e-4 for ``"xla"`` (measured 3e-5: from the second step on each
    package differentiates at its own updated parameters). For ``"q8"``
    ``a`` = 1e-3 (measured 4.5e-4, on the color MLP only): the interpret-mode
    forward contracts ``x*scale + 0.5`` into a fused multiply-add
    (``tests/test_torch_hash_grid.py::_pos_ulp_atol``), which moves the q8
    features by up to 2e-5 of their size, and the color MLP's gradient is a
    sum over samples that cancels to ~1e-6 here, so that difference shows;
    the ``"xla"`` variant holds the same code to the tight bound."""
    a = 1e-4 if pair["mode"] == "xla" else 1e-3
    for i, s in enumerate(training_run["steps"]):
        worst = _worst(s["tmu"], s["jmu"], rtol=1e-3, atol_of_max=a)
        assert max(worst.values()) <= 0, (i, worst)
        worst = _worst(s["tnu"], s["jnu"], rtol=2e-3, atol_of_max=a)
        assert max(worst.values()) <= 0, (i, worst)


def test_trainer_parameters_match_jax(training_run):
    """Parameters after ``K_STEPS`` steps, on the elements whose gradient,
    in every step, either cleared 1e-3 of the tensor's largest or was
    exactly zero (the eps rule above): rtol 1e-3 plus 1e-3 of the largest
    parameter (a step is lr = 1e-2 of an O(1e-4 .. 1) parameter, and the
    second moments it is divided by agree to ~1e-3, see the moments)."""
    steps = training_run["steps"]
    last = steps[-1]
    for k, jp in last["jparams"].items():
        clear = torch.ones_like(jp, dtype=torch.bool)
        moved = torch.zeros_like(clear)
        for s in steps:
            g = s["jgrads"][k].abs()
            clear &= (g > 1e-3 * g.max()) | (g == 0)
            moved |= g > 0
        assert float((clear & moved).float().mean()) > 0.05, k
        tol = 1e-3 * jp.abs() + 1e-3 * jp.abs().max()
        assert bool((((last["tparams"][k] - jp).abs()) <= tol)[clear].all()), k


def test_trainer_occupancy_refresh_matches_jax(training_run):
    """The grid is refreshed after steps 2 and 4 and at no other step; after
    each refresh it agrees with JAX's to rtol 1e-3 plus 1e-6 (the density
    of parameters that each package trained itself)."""
    steps = training_run["steps"]
    assert np.all(steps[0]["tocc"] == 1.0)
    assert np.any(steps[1]["tocc"] != 1.0)
    np.testing.assert_array_equal(steps[2]["tocc"], steps[1]["tocc"])
    assert np.any(steps[3]["tocc"] != steps[2]["tocc"])
    for s in steps:
        np.testing.assert_allclose(s["tocc"], s["jocc"], rtol=1e-3, atol=1e-6)


def test_trainer_writes_progress_pixels(training_run):
    trainer, steps = training_run["trainer"], training_run["steps"]
    seen = np.unique(np.concatenate([s["idx"] for s in steps]))
    pix = trainer.pred_pixels.numpy()
    assert np.count_nonzero(pix[seen]) > len(seen) // 4  # ReLU leaves some at 0
    rest = np.setdiff1d(np.arange(len(pix)), seen)
    assert np.all(pix[rest] == 0)


# -- Trainer behaviour ---------------------------------------------------------------


def _make_trainer(tmp_path, seed=0, name="run", mode="q8", update_every=2, **over):
    config = _small_config(mode, update_every)
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    tpipe = get_pipeline(config["pipeline"], tds, device="cpu")
    return Trainer(_trainer_config(**over), tds, tpipe, name, tmp_path, seed=seed, device="cpu")


def test_micro_batches_give_the_full_batch_gradient(tmp_path):
    """``micro_batch_size`` 16 of 48: the accumulated gradient is the mean
    of the three micro-batch gradients, equal to the full-batch gradient on
    the same draws to rtol 1e-4 plus 1e-6 of each tensor's largest value
    (three partial sums instead of one), and there is one optimizer update."""
    full = _make_trainer(tmp_path, name="full")
    micro = _make_trainer(tmp_path, name="micro", micro_batch_size=16)
    assert full.micro_batch is None and micro.micro_batch == 16
    for tr in (full, micro):
        tr.pipeline.compute_dtype = torch.float32
    micro.pipeline.load_state_dict(full.pipeline.state_dict())
    idx = torch.from_numpy(np.random.default_rng(8).permutation(len(full.dataset))[:N_RAYS])
    draws = full.pipeline.make_draws(N_RAYS, torch.Generator().manual_seed(1))
    parts = [
        {"sr_noise": draws["sr_noise"], "probe": draws["probe"][i : i + 16],
         "fine": draws["fine"][i : i + 16]}
        for i in (0, 16, 32)
    ]
    for tr in (full, micro):  # keep the raw accumulated gradients
        tr.optimizer.step = lambda: None
    loss_full = full.step(idx, draws=draws)
    loss_micro = micro.step(idx, draws=parts)
    np.testing.assert_allclose(float(loss_micro), float(loss_full), rtol=1e-5)
    worst = _worst(
        convert.grads_state(micro.pipeline), convert.grads_state(full.pipeline), 1e-4, 1e-6
    )
    assert max(worst.values()) <= 0, worst
    with pytest.raises(ValueError, match="micro-batches"):
        micro.step(idx, draws=parts[:2])


def test_normalize_micro():
    norm = Trainer._normalize_micro
    assert norm(None, 48) is None and norm(0, 48) is None
    assert norm(16, 48) == 16 and norm(48, 48) is None
    with pytest.warns(UserWarning, match="disabled"):
        assert norm(64, 48) is None
    with pytest.warns(UserWarning, match="shrinking to 12"):
        assert norm(14, 48) == 12


def test_batch_size_is_clamped_to_the_ray_count(tmp_path):
    with pytest.warns(UserWarning, match="clamping"):
        tr = _make_trainer(tmp_path, batch_size=10**6)
    assert tr.batch_size == len(tr.dataset) and tr.steps_per_epoch == 1


def test_restart_on_plateau_reinitialises(tmp_path, capsys):
    """A loss that stays above the threshold re-draws parameters, optimizer
    state and grid at ``check_iter`` steps after each (re)start, at most
    ``max_restarts`` times."""
    tr = _make_trainer(
        tmp_path, batch_size=256, num_iters=12, progress=False, update_every=1,
        restart_on_plateau={"check_iter": 3, "loss_threshold": 1e-9, "max_restarts": 2},
    )
    seen = {}
    for it in tr.iterate(tmp_path / "out"):
        if it == 2:
            seen["occ"] = tr.pipeline.occ.clone()
            seen["table"] = tr.pipeline.pos_table.detach().clone()
        if it in (3, 6):  # just re-initialised
            assert tr.optimizer.count == 0 and tr._restart_base == it
            assert bool((tr.pipeline.occ == 1.0).all())
            assert float(tr.pipeline.pos_table.abs().max()) <= 1e-4
            assert not torch.equal(tr.pipeline.pos_table, seen["table"])
        if it == 9:
            assert tr.optimizer.count == 3
    assert bool((seen["occ"] != 1.0).any())
    assert tr._restarts == 2 and tr.iter_count == 12 and tr.optimizer.count == 6
    assert capsys.readouterr().out.count("re-drawing the init") == 2


def test_restart_on_plateau_checks_a_healthy_run_once(tmp_path, capsys):
    tr = _make_trainer(
        tmp_path, batch_size=256, num_iters=8, progress=False,
        restart_on_plateau={"check_iter": 3, "loss_threshold": 1e9, "max_restarts": 2},
    )
    tr.train(tmp_path / "out")
    assert tr._restarts == 2 and tr._restart_base == 0  # stopped checking
    assert tr.optimizer.count == 8
    assert "re-drawing" not in capsys.readouterr().out


def _final_state(tr):
    state = {k: v.detach().clone() for k, v in tr.pipeline.state_dict().items()}
    mu, nu = convert.moments_state(tr.pipeline, tr.optimizer.adamw)
    state.update({f"mu.{k}": v for k, v in mu.items()})
    state.update({f"nu.{k}": v for k, v in nu.items()})
    return state


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Two epochs in one run against one epoch, a checkpoint, a new Trainer,
    ``load`` and the second epoch: parameters, grid and moments are equal
    bit for bit on the CPU (the checkpoint holds the generators' states)."""
    kw = dict(batch_size=250, num_iters=8, print_frequency=3)
    whole = _make_trainer(tmp_path / "a", name="whole", **kw)
    assert whole.steps_per_epoch == 4
    whole.train(tmp_path / "a" / "out")
    assert whole.epoch_idx == 2 and whole.iter_count == 8

    first = _make_trainer(tmp_path / "b", name="halves", **kw)
    for it in first.iterate(tmp_path / "b" / "out"):
        if it == 4:
            first._preempted = True  # stop at the epoch's end, as SIGTERM would
    assert first.epoch_idx == 1 and first.iter_count == 4
    assert tckpt.latest_epoch(tmp_path / "b" / "out") == 1

    second = _make_trainer(tmp_path / "b", seed=123, name="halves", **kw)
    second.load(tmp_path / "b" / "out")
    assert second.iter_count == 4 and second.optimizer.count == 4
    assert second.tensorboard_dir == first.tensorboard_dir
    second.train(tmp_path / "b" / "out")
    assert second.epoch_idx == 2 and second.iter_count == 8
    a, b = _final_state(whole), _final_state(second)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    losses = [json.loads(line) for line in open(second.tensorboard_dir / "metrics.jsonl")]
    assert {r["tag"] for r in losses} >= {"Loss", "PSNR_mean", "SSIM_mean"}


def test_checkpoint_restore_latest(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(tmp_path)
    for epoch in (1, 3, 2):
        tckpt.save_checkpoint(tmp_path, epoch, {"w": torch.full((2,), float(epoch)), "n": epoch})
    state, epoch = tckpt.restore_checkpoint(tmp_path)
    assert epoch == 3 and state["n"] == 3 and state["w"].tolist() == [3.0, 3.0]
    state, epoch = tckpt.restore_checkpoint(tmp_path, epoch=1)
    assert epoch == 1 and state["n"] == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_check_numerics_names_the_step(tmp_path):
    tr = _make_trainer(tmp_path, check_numerics=True)
    idx = torch.arange(N_RAYS)
    tr.step(idx)
    with torch.no_grad():
        tr.pipeline.surf_mlp.layers[-1].weight.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="step 2"):
        tr.step(idx)


def test_multi_device_entry_points_raise(tmp_path):
    tr = _make_trainer(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.shard(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.place("cuda:1")
    base = ["--exp-name", "x", "--config-path", "c.json", "--data-root", str(tmp_path)]
    for extra in (["--scene-filename", SCENE, "--mesh", "data=4"],
                  ["--scene-filename", SCENE, "--distributed"],
                  ["--scene-filename", f"{SCENE},{SCENE}"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_cli.main(base + extra)


def test_trainer_and_cli_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _small_config()
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    tpipe = get_pipeline(config["pipeline"], tds, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_trainer_config(), tds, tpipe, "x", tmp_path)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dict(config, trainer=_trainer_config())))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--exp-name", "x", "--config-path", str(path), "--scene-filename", SCENE,
                        "--data-root", str(tmp_path)])


def _cli_args(tmp_path, *extra):
    config = dict(_small_config(), trainer=_trainer_config(batch_size=256, print_frequency=2))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    return ["--exp-name", "cli", "--config-path", str(path), "--scene-filename", SCENE,
            "--data-root", str(tmp_path), "--device", "cpu", *extra]


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    """A few iterations of ``python -m atmonr_tpu_torch.scripts.train`` on a
    tiny synthetic granule: checkpoints, the config copy and scalar logs."""
    handler = signal.getsignal(signal.SIGTERM)
    try:
        train_cli.main(_cli_args(tmp_path, "--num-iters", "6", "--check-numerics"))
        out = tmp_path / "output" / "cli"
        assert tckpt.latest_epoch(out) == 2
        assert json.loads((out / "config.json").read_text())["trainer"]["num_iters"] == 6
        assert json.loads((out / "args.json").read_text())["scene_filename"] == SCENE
        text = capsys.readouterr().out
        assert "Epoch 2/2" in text and "PSNR_mean" in text and "Loss:" in text
        with pytest.raises(FileExistsError):
            train_cli.main(_cli_args(tmp_path, "--num-iters", "6"))
        other = ["other" if a == "cli" else a for a in _cli_args(tmp_path, "--resume")]
        with pytest.raises(FileNotFoundError):
            train_cli.main(other)
    finally:
        signal.signal(signal.SIGTERM, handler)


def test_sigterm_leaves_a_checkpoint_that_resume_takes(tmp_path, capsys):
    """SIGTERM in the middle of an epoch: the step in flight finishes, a
    checkpoint is written and ``train`` returns; ``--resume`` carries on
    from that iteration to the end."""
    handler = signal.getsignal(signal.SIGTERM)
    try:
        config = json.loads(Path(_cli_args(tmp_path)[3]).read_text())
        tds = get_dataset(config["dataset"], SCENE, device="cpu")
        tpipe = get_pipeline(config["pipeline"], tds, device="cpu")
        tr = Trainer(dict(config["trainer"], num_iters=8), tds, tpipe, "cli", tmp_path, device="cpu")
        tr.install_preemption_handler()
        out = tmp_path / "output" / "cli"
        for it in tr.iterate(out):
            if it == 2:
                os.kill(os.getpid(), signal.SIGTERM)
        assert tr.iter_count == 2 and tr.epoch_idx == 1 and tckpt.latest_epoch(out) == 1
        assert "preempted" in capsys.readouterr().out
        train_cli.main(_cli_args(tmp_path, "--resume", "--num-iters", "8"))
        state, epoch = tckpt.restore_checkpoint(out)
        assert state["iter_count"] == 8 and epoch == state["epoch_idx"] == 3
    finally:
        signal.signal(signal.SIGTERM, handler)
