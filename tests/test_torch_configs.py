"""The Instant-NGP configurations beyond the q8 flagship, on the CPU, against
the JAX package: ``fwd_mode: "auto"`` (no mode named: the bf16 table) with
each of the three samplers (occupancy grid, uniform bins, importance), the
forward and a few ``Trainer`` steps; training without an occupancy grid;
the height channel (``include_height``, a 4-D position grid); the two
pair-bucket configs (``hashed_tile: "on"``), two ``Trainer`` steps each; and
every config file under ``configs/``.

The small config is ``tests/test_torch_pipeline.py``'s with ``fwd_mode``
removed from both hash grids. On the CPU the JAX dispatch runs the exact f32
gather whatever the mode, so ``atmonr_tpu.models.hash_grid._fwd_dispatch`` is
patched to what it does on the TPU for ``"auto"``: the Pallas kernel in
bf16 mode (here in interpret mode). Both packages get the same parameters,
index vectors and draws (made from JAX keys), float32 MLP products and one
float64 host preprocessor, as ``tests/test_torch_train.py`` does.
"""

import copy
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import atmonr_tpu_torch
from atmonr_tpu.data import batching as jbatching
from atmonr_tpu.models import hash_grid as jhg
from atmonr_tpu.ops import hash_gather_pallas as jhgp
from atmonr_tpu.ops import samplers as jsamp
from atmonr_tpu.ops.hash_gather_pallas import hash_encode_pallas_fwd
from atmonr_tpu.pipelines import instant_ngp as jngp
from atmonr_tpu.pipelines.instant_ngp import InstantNGPPipeline as JaxPipeline
from atmonr_tpu.training import schedules as jschedules
from atmonr_tpu_torch import Trainer, convert, get_dataset, get_pipeline
from atmonr_tpu_torch.models import hash_grid as thg
from atmonr_tpu_torch.ops import hash_bwd as thbo
from atmonr_tpu_torch.ops import samplers as tsamp
from atmonr_tpu_torch.pipelines import instant_ngp as tngp
from atmonr_tpu_torch.training import checkpoint as tckpt
from test_torch_nerf import _host_heights, _shared
from test_torch_pipeline import (
    N_RAYS,
    SCENE,
    _bad_rays,
    _config,
    _jax_dataset,
    _port_dataset,
    _share_preprocessor,
)
from test_torch_train import (
    _adam_state,
    _batches,
    _final_state,
    _jax_loss_and_grads,
    _t,
    _torch_loss_and_grads,
    _trainer_config,
    _worst,
)

SAMPLERS = ("occupancy", "uniform", "importance")
N_COARSE, N_FINE = 8, 6
K_STEPS = 2
# At the U(-1e-4, 1e-4) init every density is ~1e-5, and the importance
# sampler's coarse weights alpha = 1 - exp(-sigma * delta) are then no larger
# than the rounding of exp (2^-24), which differs between XLA:CPU and torch:
# the pdf would be noise. The importance variant scales the position table so
# that densities are O(0.1) and the weights mean something.
IMPORTANCE_TABLE_BOOST = 1e4


def _auto_config(sampler: str, update_every: int = 2) -> dict:
    """The small config with no ``fwd_mode`` (so ``"auto"``) and the named
    sampler."""
    config = _config("auto")
    pipe = config["pipeline"]
    del pipe["instant_ngp"]["encoding"]["fwd_mode"]
    del pipe["instant_ngp"]["surface_encoding"]["nested"][0]["fwd_mode"]
    if sampler == "occupancy":
        pipe["occupancy"]["update_every"] = update_every
    else:
        del pipe["occupancy"]
    if sampler == "importance":
        pipe["importance_sampler"] = {"n_coarse": N_COARSE, "n_fine": N_FINE}
    return config


def _bf16_dispatch(table, x, cfg, sr_noise=None, tiles=None):
    """``_fwd_dispatch`` on the TPU for ``fwd_mode: "auto"``."""
    return hash_encode_pallas_fwd(table, x, cfg, "bf16")


def _jax_draws(key, jpipe, params, b, sampler):
    """The draws JAX's stochastic forward makes from ``key``, under the
    port's names."""
    key2, k_sr = jax.random.split(key)
    draws = {"sr_noise": jax.random.uniform(k_sr, params["pos_table"].shape)}
    if sampler == "uniform":
        n = jpipe.config["num_samples_per_ray"]
        draws["bins"] = jax.random.uniform(key2, (b, n))
        return draws
    ka, kf = jax.random.split(key2)
    if sampler == "occupancy":
        oc = jpipe.occ_cfg
        draws["probe"] = jax.random.uniform(ka, (b, oc.n_probe))
        draws["fine"] = jax.random.uniform(kf, (b, oc.n_fine), maxval=1.0 / oc.n_fine)
    else:
        draws["coarse"] = jax.random.uniform(ka, (b, N_COARSE))
        draws["fine"] = jax.random.uniform(kf, (b, N_FINE))
    return {k: _t(v) for k, v in draws.items()}


@pytest.fixture(scope="module", params=SAMPLERS)
def pair(request):
    """The JAX pipeline (bf16 Pallas forward patched in for the module) and
    the port's at identical parameters."""
    sampler = request.param
    config = _auto_config(sampler)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhg, "_fwd_dispatch", _bf16_dispatch)
        jds = _jax_dataset(config)
        jpipe = JaxPipeline(config["pipeline"], jds)
        jpipe.compute_dtype = jnp.float32
        params = jpipe.init_params(jax.random.PRNGKey(0))
        if sampler == "importance":
            params["pos_table"] = params["pos_table"] * IMPORTANCE_TABLE_BOOST
        tds = _port_dataset(config["dataset"])
        tpipe = get_pipeline(copy.deepcopy(config["pipeline"]), tds, device="cpu")
        tpipe.compute_dtype = torch.float32
        tpipe.load_params(convert.params_from_jax(params))
        _share_preprocessor(jpipe, tpipe, jds.scene_transform)
        aux = jpipe.init_aux()
        if sampler == "occupancy":
            k_occ = jax.random.PRNGKey(1)
            aux = jpipe.update_aux(params, aux, k_occ)
            tpipe.update_aux(jitter=_t(jax.random.uniform(k_occ, (jpipe.occ_cfg.num_cells, 3))))
        yield {"sampler": sampler, "config": config, "jds": jds, "jpipe": jpipe, "params": params,
               "tds": tds, "tpipe": tpipe, "aux": aux}


def _draws_for(pair, key):
    draws = _jax_draws(key, pair["jpipe"], pair["params"], N_RAYS, pair["sampler"])
    return {k: _t(v) for k, v in draws.items()}


def test_auto_resolves_to_the_bf16_kernel_mode(pair):
    tpipe = pair["tpipe"]
    assert tpipe.pos_cfg.fwd_mode == "auto" and thg.resolve_fwd_mode(tpipe.pos_cfg) == "bf16"
    (surf_cfg,) = tpipe.surf_cfgs.values()
    assert surf_cfg.fwd_mode == "auto" and thg.resolve_fwd_mode(surf_cfg) == "bf16"
    has_occ = pair["sampler"] == "occupancy"
    assert (tpipe.occ_cfg is not None) == has_occ == ("occ" in tpipe.state_dict())
    assert (pair["aux"] != {}) == has_occ


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "draws"])
def test_forward_matches_jax(pair, stochastic):
    """Every output of ``forward`` at the q8 variant's tolerances
    (``tests/test_torch_pipeline.py::_bad_rays``: rtol 1e-5 plus 1e-6 of the
    output's largest value; at most one of the 48 rays may place a sample
    elsewhere). bf16 needs nothing wider: the table is rounded identically
    on both sides and everything after it is float32."""
    jpipe, tpipe, params = pair["jpipe"], pair["tpipe"], pair["params"]
    jbatch, tbatch = _batches(pair["tds"], np.arange(N_RAYS))
    key = jax.random.PRNGKey(2) if stochastic else None
    draws = _draws_for(pair, key) if stochastic else None
    jout = jpipe.forward(params, jbatch, key=key, aux=pair["aux"])
    with torch.no_grad():
        tout = tpipe(tbatch, draws=draws)
    n = tout["z_vals_fine"].shape[1]
    want_n = {"occupancy": 6, "uniform": 16, "importance": N_COARSE + N_FINE}[pair["sampler"]]
    assert n == want_n
    bad = _bad_rays(jout, tout, n)
    assert len(bad) <= 1, bad
    if stochastic:  # the draws were used
        with torch.no_grad():
            det = tpipe(tbatch)
        assert not torch.equal(det["z_vals_fine"], tout["z_vals_fine"])


def test_importance_coarse_pass_has_no_gradient_and_no_noise():
    """The coarse pass reads the position grid without stochastic-rounding
    noise and under ``no_grad``: the sample positions carry no graph, and
    the table gradient comes from the fine pass alone (K2's plain version on
    the fine pass's own positions and cotangent)."""
    config = _auto_config("importance")
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    tpipe = get_pipeline(config["pipeline"], tds, device="cpu")
    with torch.no_grad():
        tpipe.pos_table.mul_(IMPORTANCE_TABLE_BOOST)
    _, tbatch = _batches(tds, np.arange(N_RAYS))
    draws = tpipe.make_draws(N_RAYS, torch.Generator().manual_seed(4))
    x, z = tpipe.sample_points(tbatch, draws)
    assert not x.requires_grad and not z.requires_grad
    assert x.shape == (N_RAYS * (N_COARSE + N_FINE), 3)
    other = dict(draws, sr_noise=torch.rand(draws["sr_noise"].shape))
    assert torch.equal(tpipe.sample_points(tbatch, other)[0], x)
    seen = {}
    real = thbo.hash_bwd_plain

    def spy(px, g, cfg):
        seen[cfg.n_dims] = seen.get(cfg.n_dims, 0) + 1
        if cfg.n_dims == 3:
            assert torch.equal(px, x)
        return real(px, g, cfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thbo, "hash_bwd_plain", spy)
        _torch_loss_and_grads(tpipe, tbatch, draws)
    assert seen == {3: 1, 2: 1}


def test_step_gradients_match_jax(pair):
    """Loss and all 13 gradients of one stochastic step against
    ``jax.grad``: every ray takes the same samples (checked first); per
    tensor rtol 1e-4 plus 1e-5 of its largest value, as the q8 variant of
    ``tests/test_torch_train.py`` (float32 sums in another order, and the
    one-ulp difference of ``pos`` inside the interpret-mode forward)."""
    jpipe, tpipe, params = pair["jpipe"], pair["tpipe"], pair["params"]
    idx = np.random.default_rng(6).permutation(len(pair["tds"]))[:N_RAYS]
    jbatch, tbatch = _batches(pair["tds"], idx)
    key = jax.random.PRNGKey(2)
    draws = _draws_for(pair, key)
    jloss, jgrads = _jax_loss_and_grads(jpipe, params, jbatch, key, pair["aux"])
    tloss, tgrads = _torch_loss_and_grads(tpipe, tbatch, draws)
    jz = jpipe.forward(params, jbatch, key=key, aux=pair["aux"])["z_vals_fine"]
    with torch.no_grad():
        tz = tpipe(tbatch, draws=draws)["z_vals_fine"]
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jg = convert.params_from_jax(jgrads)
    assert len(jg) == 13 and set(jg) == set(dict(tpipe.named_parameters()))
    worst = _worst(tgrads, jg, rtol=1e-4, atol_of_max=1e-5)
    assert max(worst.values()) <= 0, worst
    for k in jg:
        assert float(jg[k].abs().max()) > 0, k


@pytest.fixture(scope="module")
def training_run(pair, tmp_path_factory):
    """``K_STEPS`` steps of the port's ``Trainer`` and of a JAX loop (the JAX
    pipeline's ``make_optimizer``) on the same index vectors and draws; with
    the occupancy sampler a refresh after the second."""
    jpipe, params, tds, sampler = pair["jpipe"], pair["params"], pair["tds"], pair["sampler"]
    tcfg = _trainer_config()
    tpipe = get_pipeline(copy.deepcopy(pair["config"]["pipeline"]), tds, device="cpu")
    tpipe.compute_dtype = torch.float32
    tpipe.point_preprocessor = pair["tpipe"].point_preprocessor
    trainer = Trainer(tcfg, tds, tpipe, "parity", tmp_path_factory.mktemp("parity"), device="cpu")
    tpipe.load_params(convert.params_from_jax(params))
    assert trainer.aux_update_every == (2 if sampler == "occupancy" else 0)
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
        jitter = None
        if sampler == "occupancy":
            if (s + 1) % 2 == 0:
                aux = jpipe.update_aux(params, aux, k_aux)
            jitter = _t(jax.random.uniform(k_aux, (jpipe.occ_cfg.num_cells, 3)))
        draws = {k: _t(v) for k, v in _jax_draws(key, jpipe, pair["params"], N_RAYS, sampler).items()}
        tloss = trainer.step(_t(idx), draws=draws, aux_jitter=jitter)
        mu, nu = convert.moments_state(tpipe, trainer.optimizer.adamw)
        adam = _adam_state(opt_state)
        steps.append({
            "jloss": float(jloss), "tloss": float(tloss),
            "jmu": convert.params_from_jax(adam.mu), "jnu": convert.params_from_jax(adam.nu),
            "tmu": mu, "tnu": nu,
        })
    occ = (np.asarray(aux["occ"]), tpipe.occ.numpy()) if sampler == "occupancy" else None
    return {"steps": steps, "trainer": trainer, "occ": occ}


def test_trainer_losses_match_jax(training_run):
    for s in training_run["steps"]:
        assert np.isfinite(s["tloss"])
        np.testing.assert_allclose(s["tloss"], s["jloss"], rtol=1e-4)
    assert training_run["trainer"].optimizer.count == K_STEPS


def test_trainer_moments_match_jax(training_run):
    """AdamW's moments after every step, the clip inside, at the q8
    variant's tolerances of ``tests/test_torch_train.py::
    test_trainer_moments_match_jax``: ``mu`` to rtol 1e-3 and ``nu`` to rtol
    2e-3, each plus 1e-3 of the tensor's largest value. As with q8, the
    interpret-mode forward contracts ``x*scale + 0.5`` into a fused
    multiply-add, and the color MLP's gradient is a sum that cancels; the
    bf16 table itself needs nothing wider."""
    for i, s in enumerate(training_run["steps"]):
        worst = _worst(s["tmu"], s["jmu"], rtol=1e-3, atol_of_max=1e-3)
        assert max(worst.values()) <= 0, (i, worst)
        worst = _worst(s["tnu"], s["jnu"], rtol=2e-3, atol_of_max=1e-3)
        assert max(worst.values()) <= 0, (i, worst)


def test_trainer_occupancy_refresh_only_with_a_grid(training_run):
    occ = training_run["occ"]
    if occ is None:
        assert not hasattr(training_run["trainer"].pipeline, "occ")
    else:
        assert np.any(occ[1] != 1.0)
        np.testing.assert_allclose(occ[1], occ[0], rtol=1e-3, atol=1e-6)


# -- training without an occupancy grid ---------------------------------------------


def _make_trainer(tmp_path, sampler, name="run", seed=0, **over):
    config = _auto_config(sampler)
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    tpipe = get_pipeline(config["pipeline"], tds, device="cpu")
    return Trainer(_trainer_config(**over), tds, tpipe, name, tmp_path, seed=seed, device="cpu")


@pytest.mark.parametrize("sampler", ["uniform", "importance"])
def test_resume_without_occupancy_equals_an_uninterrupted_run(tmp_path, sampler):
    """Six steps in one run against three, a checkpoint, a new Trainer,
    ``load`` and three more: the checkpoint has no occupancy entry, the
    refresh cadence is off, and parameters and moments are equal bit for bit
    on the CPU."""
    kw = dict(batch_size=250, num_iters=6, print_frequency=2)
    whole = _make_trainer(tmp_path / "a", sampler, "whole", **kw)
    assert whole.steps_per_epoch == 4 and whole.aux_update_every == 0
    whole.train(tmp_path / "a" / "out")
    assert whole.iter_count == 6

    first = _make_trainer(tmp_path / "b", sampler, "halves", **kw)
    for it in first.iterate(tmp_path / "b" / "out"):
        if it == 3:
            first._preempted = True
    assert first.iter_count == 3
    state, _ = tckpt.restore_checkpoint(tmp_path / "b" / "out")
    assert "occ" not in state["pipeline"] and "pos_table" in state["pipeline"]

    second = _make_trainer(tmp_path / "b", sampler, "halves", seed=123, **kw)
    second.load(tmp_path / "b" / "out")
    assert second.iter_count == 3 and second.optimizer.count == 3
    # the interrupted epoch is not replayed: the resumed run starts a new
    # permutation, so it is compared with a run interrupted the same way
    second.train(tmp_path / "b" / "out")
    assert second.iter_count == 6

    third = _make_trainer(tmp_path / "c", sampler, "again", **kw)
    for it in third.iterate(tmp_path / "c" / "out"):
        if it == 3:
            third._preempted = True
    third._preempted = False
    third.train(tmp_path / "c" / "out")
    a, b = _final_state(third), _final_state(second)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert bool(torch.isfinite(a["pos_table"]).all())


def test_micro_batches_with_the_uniform_sampler(tmp_path):
    """``micro_batch_size`` 16 of 48 with the uniform sampler (as
    ``configs/instant_ngp.json`` splits 8,192 rays into 8): three forward
    and backward passes, one optimizer update, and the accumulated gradient
    equal to the un-split step's on the same draws to rtol 1e-4 plus 1e-6 of
    each tensor's largest value; the loss to 1e-6."""
    full = _make_trainer(tmp_path, "uniform", "full")
    micro = _make_trainer(tmp_path, "uniform", "micro", micro_batch_size=16)
    assert full.micro_batch is None and micro.micro_batch == 16
    for tr in (full, micro):
        tr.pipeline.compute_dtype = torch.float32
    micro.pipeline.load_state_dict(full.pipeline.state_dict())
    idx = torch.from_numpy(np.random.default_rng(8).permutation(len(full.dataset))[:N_RAYS])
    draws = full.pipeline.make_draws(N_RAYS, torch.Generator().manual_seed(1))
    assert set(draws) == {"sr_noise", "bins"} and draws["bins"].shape == (N_RAYS, 16)
    parts = [{"sr_noise": draws["sr_noise"], "bins": draws["bins"][i : i + 16]} for i in (0, 16, 32)]
    calls = {"full": 0, "micro": 0}
    for name, tr in (("full", full), ("micro", micro)):  # count, and keep the raw gradients
        tr.optimizer.step = lambda name=name: calls.__setitem__(name, calls[name] + 1)
    loss_full = full.step(idx, draws=draws)
    loss_micro = micro.step(idx, draws=parts)
    assert calls == {"full": 1, "micro": 1}
    np.testing.assert_allclose(float(loss_micro), float(loss_full), rtol=1e-6)
    worst = _worst(
        convert.grads_state(micro.pipeline), convert.grads_state(full.pipeline), 1e-4, 1e-6
    )
    assert max(worst.values()) <= 0, worst


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_make_draws_names_the_samplers_draws(tmp_path, sampler):
    config = _auto_config(sampler)
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    tpipe = get_pipeline(config["pipeline"], tds, device="cpu")
    draws = tpipe.make_draws(10, torch.Generator().manual_seed(0))
    want = {
        "occupancy": {"probe": (10, 8), "fine": (10, 6)},
        "uniform": {"bins": (10, 16)},
        "importance": {"coarse": (10, N_COARSE), "fine": (10, N_FINE)},
    }[sampler]
    shapes = {k: tuple(v.shape) for k, v in draws.items() if k != "sr_noise"}
    assert shapes == want and draws["sr_noise"].shape == tpipe.pos_table.shape
    for v in draws.values():
        assert float(v.min()) >= 0.0 and float(v.max()) < 1.0
    tpipe.init_aux()
    tpipe.update_aux(generator=torch.Generator().manual_seed(1))  # nothing without a grid


# -- every config file ---------------------------------------------------------------

CONFIGS = sorted(Path(p).name for p in glob.glob(str(Path(__file__).parent.parent / "configs" / "instant_ngp*.json")))
PAIR_BUCKET = ("instant_ngp_pb.json", "instant_ngp_occ21_pb.json")


def _cut_config(name: str) -> dict:
    """A config file under ``configs/``, Instant-NGP tables above 2^16
    entries cut to ``log2_hashmap_size`` 12 (they change no code path: the
    gather has no size gate) and 1,024 samples per ray to 64, for the CPU's
    sake."""
    config = atmonr_tpu_torch.load_config(Path(__file__).parent.parent / "configs" / name)
    pipe_cfg = config["pipeline"]
    if pipe_cfg["type"] == "InstantNGP":
        ngp = pipe_cfg["instant_ngp"]
        for enc in (ngp["encoding"], ngp["surface_encoding"]["nested"][0]):
            if enc["log2_hashmap_size"] > 16:
                enc["log2_hashmap_size"] = 12
        pipe_cfg["num_samples_per_ray"] = min(pipe_cfg["num_samples_per_ray"], 64)
    return config


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_builds_a_pipeline(name):
    """Every Instant-NGP config under ``configs/`` builds a port pipeline on
    a tiny granule (tables cut as ``_cut_config`` says) and renders 4 rays.
    The two pair-bucket ones resolve the position grid to the exact gather
    over the bf16 table, and the surface grid to the bf16 kernel."""
    config = _cut_config(name)
    pipe_cfg = config["pipeline"]
    named = pipe_cfg["instant_ngp"]["encoding"].get("fwd_mode", "auto")
    ds = get_dataset(config["dataset"], "synthetic:8x4x2", device="cpu")
    pipe = get_pipeline(pipe_cfg, ds, device="cpu")
    want = "q8" if named == "q8" else "bf16"
    want_pos = "xla_bf16" if name in PAIR_BUCKET else want
    assert (pipe.pos_cfg.hashed_tile == "on") == (name in PAIR_BUCKET)
    assert thg.resolve_fwd_mode(pipe.pos_cfg) == want_pos
    assert all(thg.resolve_fwd_mode(c) == want for c in pipe.surf_cfgs.values())
    batch = {k: torch.from_numpy(v[:4]) for k, v in ds.host_rays().items()}
    with torch.no_grad():
        out = pipe(batch)
    n = out["z_vals_fine"].shape[1]
    if pipe_cfg.get("occupancy"):
        assert n == pipe_cfg["occupancy"]["n_fine"]
    elif pipe_cfg.get("importance_sampler"):
        assert n == sum(pipe_cfg["importance_sampler"].values())
    else:
        assert n == pipe_cfg["num_samples_per_ray"]
    assert out["color_map_fine"].shape == (4, pipe_cfg["num_bands"])
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_the_config_list_is_the_seventeen():
    """All 18 files under ``configs/`` (the 17 Instant-NGP ones above and
    ``nerf.json``) build a port pipeline of their type on the CPU."""
    names = sorted(Path(p).name for p in glob.glob(str(Path(__file__).parent.parent / "configs" / "*.json")))
    assert len(CONFIGS) == 17 and set(PAIR_BUCKET) <= set(CONFIGS)
    assert len(names) == 18 and set(names) == set(CONFIGS) | {"nerf.json"}
    ds = get_dataset(_auto_config("uniform")["dataset"], "synthetic:8x4x2", device="cpu")
    for name in names:
        pipe_cfg = _cut_config(name)["pipeline"]
        pipe = get_pipeline(pipe_cfg, ds, device="cpu")
        want = {"NeRF": atmonr_tpu_torch.NeRFPipeline, "InstantNGP": tngp.InstantNGPPipeline}
        assert type(pipe) is want[pipe_cfg["type"]], name


def test_include_height_still_raises():
    """``include_height`` with an occupancy grid is refused, as the JAX
    package asserts (the dense refresh has no height to append), and so is
    ``include_height`` with the horizontal preprocessor."""
    ds = get_dataset(_auto_config("uniform")["dataset"], SCENE, device="cpu")
    occ = _auto_config("occupancy")["pipeline"]
    with pytest.raises(ValueError, match="occupancy grid requires include_height=false"):
        get_pipeline(dict(occ, include_height=True, point_preprocessor=None), ds, device="cpu")
    with pytest.raises(ValueError, match="horizontal"):
        get_pipeline(dict(occ, include_height=True), ds, device="cpu")


# -- the TPU dispatch of grids beyond the Pallas gate ---------------------------------


def _tpu_dispatch(table, x, cfg, sr_noise=None, tiles=None):
    """What ``_fwd_dispatch`` computes on the TPU for ``fwd_mode: "auto"``:
    the gather over the bf16-cast table, by the XLA path (the 4-D grid of
    ``include_height`` and the pair-bucket grids take it there too; the 2-D
    and 3-D grids inside the Pallas gate take the bf16 kernel, which
    computes the same gather, ``tests/test_torch_hash_grid.py::
    test_kernel_mode_plain_matches_pallas_interpret``, and whose interpret
    mode takes minutes at 16 levels on the CPU)."""
    assert cfg.fwd_mode == "auto"
    return jhg._hash_encode_impl(table.astype(jnp.bfloat16), x, cfg, tiles)


# -- include_height ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tall_pair():
    """The small config with the uniform sampler, ``include_height`` and no
    preprocessor, in both packages at identical parameters; one float64
    ``append_heights`` shared (as ``tests/test_torch_nerf.py`` does: the
    float32 altitude solves differ by ~1.5 m). The position table is
    scaled by ``IMPORTANCE_TABLE_BOOST``, for the reason given there: at
    the init's densities the compositing weights would be exp's rounding,
    and the color MLP's gradient with them."""
    config = _auto_config("uniform")
    config["pipeline"].update(include_height=True, point_preprocessor=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhg, "_fwd_dispatch", _tpu_dispatch)
        jds = _jax_dataset(config)
        jpipe = JaxPipeline(config["pipeline"], jds)
        jpipe.compute_dtype = jnp.float32
        params = jpipe.init_params(jax.random.PRNGKey(0))
        params["pos_table"] = params["pos_table"] * IMPORTANCE_TABLE_BOOST
        tds = _port_dataset(config["dataset"])
        tpipe = get_pipeline(copy.deepcopy(config["pipeline"]), tds, device="cpu")
        tpipe.compute_dtype = torch.float32
        tpipe.load_params(convert.params_from_jax(params))
        args = (jpipe.ray_origin_height, jpipe.scale, jpipe.offset)
        jf, tf = _shared(_host_heights(jpipe.scale, jpipe.offset, jpipe.ray_origin_height),
                         lambda p: jsamp.append_heights(p, *args),
                         lambda p: tsamp.append_heights(p, *args), 4)
        mp.setattr(jngp, "append_heights", lambda p, *a: jf(p))
        mp.setattr(tngp, "append_heights", lambda p, *a: tf(p))
        yield {"jpipe": jpipe, "tpipe": tpipe, "params": params, "tds": tds}


def test_include_height_grid_is_four_dimensional(tall_pair):
    """The position grid takes the height as a 4th input and, beyond the
    kernels' D in (2, 3) as beyond JAX's Pallas gate, resolves to the exact
    gather over the bf16 table; the surface grid keeps the bf16 kernel."""
    tpipe = tall_pair["tpipe"]
    assert tpipe.num_inputs == tpipe.pos_cfg.n_dims == 4
    assert not jhgp.supported(tall_pair["jpipe"].pos_cfg, "bf16")
    assert thg.resolve_fwd_mode(tpipe.pos_cfg) == "xla_bf16"
    assert [thg.resolve_fwd_mode(c) for c in tpipe.surf_cfgs.values()] == ["bf16"]
    _, tbatch = _batches(tall_pair["tds"], np.arange(N_RAYS))
    x, _ = tpipe.sample_points(tbatch)
    assert x.shape == (N_RAYS * 16, 4) and float(x[:, 3].max()) > 0


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "draws"])
def test_include_height_forward_matches_jax(tall_pair, stochastic):
    """Every output at ``_bad_rays``' tolerances (rtol 1e-5 plus 1e-6 of the
    largest value); at most one ray may place a sample elsewhere."""
    jpipe, tpipe, params = tall_pair["jpipe"], tall_pair["tpipe"], tall_pair["params"]
    jbatch, tbatch = _batches(tall_pair["tds"], np.arange(N_RAYS))
    key = jax.random.PRNGKey(2) if stochastic else None
    draws = _draws_for({"jpipe": jpipe, "params": params, "sampler": "uniform"}, key) \
        if stochastic else None
    jout = jpipe.forward(params, jbatch, key=key)
    with torch.no_grad():
        tout = tpipe(tbatch, draws=draws)
    bad = _bad_rays(jout, tout, 16)
    assert len(bad) <= 1, bad


def test_include_height_gradients_match_jax(tall_pair):
    """Loss to rtol 1e-5 and all 13 gradients of one stochastic step to rtol
    1e-4 plus 1e-5 of each tensor's largest value, as
    ``test_step_gradients_match_jax``."""
    jpipe, tpipe, params = tall_pair["jpipe"], tall_pair["tpipe"], tall_pair["params"]
    idx = np.random.default_rng(6).permutation(len(tall_pair["tds"]))[:N_RAYS]
    jbatch, tbatch = _batches(tall_pair["tds"], idx)
    key = jax.random.PRNGKey(2)
    draws = _draws_for({"jpipe": jpipe, "params": params, "sampler": "uniform"}, key)
    jloss, jgrads = _jax_loss_and_grads(jpipe, params, jbatch, key, {})
    tloss, tgrads = _torch_loss_and_grads(tpipe, tbatch, draws)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jg = convert.params_from_jax(jgrads)
    worst = _worst(tgrads, jg, rtol=1e-4, atol_of_max=1e-5)
    assert max(worst.values()) <= 0, worst
    assert float(jg["pos_table"].abs().max()) > 0


# -- the pair-bucket configs -----------------------------------------------------------


def _pb_draws(key, jpipe, b):
    """The draws JAX's forward makes from ``key`` with no stochastic
    rounding (no ``sr_noise`` split), under the port's names."""
    if jpipe.occ_cfg is None:
        return {"bins": _t(jax.random.uniform(key, (b, jpipe.config["num_samples_per_ray"])))}
    oc = jpipe.occ_cfg
    kp, kf = jax.random.split(key)
    return {"probe": _t(jax.random.uniform(kp, (b, oc.n_probe))),
            "fine": _t(jax.random.uniform(kf, (b, oc.n_fine), maxval=1.0 / oc.n_fine))}


@pytest.fixture(scope="module", params=list(PAIR_BUCKET))
def pb_run(request, tmp_path_factory):
    """``K_STEPS`` steps of the port's ``Trainer`` and of a JAX loop (the JAX
    pipeline's ``make_optimizer`` on its schedule) on a pair-bucket config
    file as ``_cut_config`` cuts it (2^12 tables, 64 uniform samples), its
    own optimizer and schedule at 48 rays a step, the same index vectors
    and draws, float32 MLPs and one float64 preprocessor."""
    name = request.param
    config = _cut_config(name)
    pcfg = config["pipeline"]
    tcfg = dict(config["trainer"], batch_size=N_RAYS, num_iters=40, print_frequency=2)
    tcfg.pop("micro_batch_size", None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhg, "_fwd_dispatch", _tpu_dispatch)
        jds = _jax_dataset(config)
        jpipe = JaxPipeline(pcfg, jds)
        jpipe.compute_dtype = jnp.float32
        params = jpipe.init_params(jax.random.PRNGKey(0))
        tds = _port_dataset(config["dataset"])
        tpipe = get_pipeline(copy.deepcopy(pcfg), tds, device="cpu")
        tpipe.compute_dtype = torch.float32
        _share_preprocessor(jpipe, tpipe, jds.scene_transform)
        trainer = Trainer(tcfg, tds, tpipe, "pb", tmp_path_factory.mktemp("pb"), device="cpu")
        tpipe.load_params(convert.params_from_jax(params))
        jopt = jpipe.make_optimizer(
            tcfg["optimizer"],
            jschedules.make_lr_schedule(tcfg["scheduler"], tcfg["optimizer"], tcfg["num_iters"],
                                        trainer.steps_per_epoch))
        opt_state = jopt.init(params)
        aux = jpipe.init_aux()
        jrays = {k: jnp.asarray(v) for k, v in tds.host_rays().items()}
        rng = np.random.default_rng(7)
        steps = []
        for s in range(K_STEPS):
            idx = rng.permutation(len(tds))[:N_RAYS]
            key = jax.random.fold_in(jax.random.PRNGKey(3), s)
            jbatch = jbatching.gather_batch(jrays, jnp.asarray(idx))
            jloss, jgrads = _jax_loss_and_grads(jpipe, params, jbatch, key, aux)
            updates, opt_state = jopt.update(jgrads, opt_state, params)
            params = optax.apply_updates(params, updates)
            tloss = trainer.step(_t(idx), draws=_pb_draws(key, jpipe, N_RAYS))
            mu, nu = convert.moments_state(tpipe, trainer.optimizer.adamw)
            adam = _adam_state(opt_state)
            steps.append({
                "jloss": float(jloss), "tloss": float(tloss),
                "jmu": convert.params_from_jax(adam.mu), "jnu": convert.params_from_jax(adam.nu),
                "tmu": mu, "tnu": nu,
            })
    return {"name": name, "steps": steps, "trainer": trainer}


def test_pair_bucket_trainer_matches_jax(pb_run):
    """Both pair-bucket configs: the position grid takes the window hash at
    its hashed levels and no kernel; losses to rtol 1e-5; AdamW's moments
    after each step at ``test_trainer_moments_match_jax``'s tolerances (the
    surface grid's interpret-mode Pallas forward contracts ``x*scale + 0.5``
    into a fused multiply-add)."""
    pipe = pb_run["trainer"].pipeline
    cfg = pipe.pos_cfg
    assert cfg.hashed_tile == "on" and thg.resolve_fwd_mode(cfg) == "xla_bf16"
    assert any(thg._use_hashed_tiles(cfg, lv) for lv in range(cfg.n_levels))
    assert (pipe.occ_cfg is not None) == (pb_run["name"] == "instant_ngp_occ21_pb.json")
    for i, s in enumerate(pb_run["steps"]):
        assert np.isfinite(s["tloss"])
        np.testing.assert_allclose(s["tloss"], s["jloss"], rtol=1e-5)
        worst = _worst(s["tmu"], s["jmu"], rtol=1e-3, atol_of_max=1e-3)
        assert max(worst.values()) <= 0, (i, worst)
        worst = _worst(s["tnu"], s["jnu"], rtol=2e-3, atol_of_max=1e-3)
        assert max(worst.values()) <= 0, (i, worst)
    assert pb_run["trainer"].optimizer.count == K_STEPS
