"""JAX's inits in the port and the branch collapse, on the CPU.

- ``atmonr_tpu_torch/utils/threefry.py`` against ``jax.random`` (``PRNGKey``,
  ``split``, ``fold_in``, ``uniform``), bit for bit;
- ``convert.jax_ngp_init`` against ``InstantNGPPipeline.init_params``, bit
  for bit, for the flagship, its quiet-head variant and the dry run's tiny
  config;
- the same init, index vectors and draws through both packages' train
  steps at bf16 MLP products: at the small size of
  ``tests/test_torch_train.py`` for 24 steps (losses in an envelope), and
  at full width on the collapse tool's cell for 200 steps (``slow``: the
  outcome, collapsed or healthy, by the restart guard's rule);
- the collapse tool itself at a few steps.

The JAX side's ``q8`` forward is JAX's own per-level quantizer
(``quantize_level_q8``, stochastic rounding included) and the exact XLA
gather over the dequantized table: on the CPU its dispatch would run the
f32 gather, and the Pallas kernel's interpret mode takes minutes at full
width. The two compute the same products up to float32 rounding
(``tests/test_hash_pallas.py::test_pallas_fwd_q8_matches_quantized_table``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as jax_entry
from _torch_threads import one_torch_thread
from atmonr_tpu.data.harp2 import HARP2Dataset as JaxHARP2Dataset
from atmonr_tpu.data.synthetic import make_synthetic_granule as jax_granule
from atmonr_tpu.geo import wgs84 as jwgs84
from atmonr_tpu.models import hash_grid as jhg
from atmonr_tpu.ops.hash_gather_pallas import quantize_level_q8
from atmonr_tpu.pipelines.instant_ngp import InstantNGPPipeline as JaxPipeline
from atmonr_tpu.utils import load_config as jax_load_config
from atmonr_tpu_torch import convert, get_pipeline
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
from atmonr_tpu_torch.geo import wgs84 as twgs84
from atmonr_tpu_torch.tools import REPO
from atmonr_tpu_torch.tools import repro_occ15_collapse as collapse
from atmonr_tpu_torch.utils import threefry
from test_torch_pipeline import _share_preprocessor
from test_torch_train import _jax_draws, _small_config

SEEDS = [0, 4, 4000, -1, 2**31 - 1]
FLAGSHIP = "configs/instant_ngp_tpu_occ13.json"
COLLAPSE_CONFIG = "configs/instant_ngp_tpu_occ13_q8sr.json"


# -- the PRNG ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    ours = threefry.prng_key(seed)
    assert ours.dtype == np.uint32 and np.array_equal(ours, np.asarray(key))
    for num in (2, 3, 6, 7):
        assert np.array_equal(threefry.split(ours, num), np.asarray(jax.random.split(key, num)))
    for data in (0, 1, 17, 7919 * 3, 2**32 - 1):
        assert np.array_equal(threefry.fold_in(ours, data), np.asarray(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("shape,lo,hi", [
    ((5,), 0.0, 1.0),
    ((3, 4), -1e-4, 1e-4),
    ((1000, 2), -1e-4, 1e-4),
    ((32, 27), -(6.0 / 59.0) ** 0.5, (6.0 / 59.0) ** 0.5),
    ((7, 3, 2), 0.0, 1.0 / 24.0),
])
def test_uniform_matches_jax(shape, lo, hi):
    for seed in SEEDS:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        want = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
        got = threefry.uniform(threefry.fold_in(threefry.prng_key(seed), 3), shape, lo, hi)
        assert got.dtype == np.float32 and got.shape == shape
        assert np.array_equal(got, want), (seed, int((got != want).sum()))


# -- the Instant-NGP init ------------------------------------------------------------------


def _small_jax_dataset(dataset_config):
    return JaxHARP2Dataset(dataset_config, jax_granule(height=12, width=8, views_per_band=2),
                           ray_builder=lambda *a, **k: jwgs84.get_rays(*a, **k, xp=np))


@pytest.mark.parametrize("name,seed", [
    (FLAGSHIP, 0), (FLAGSHIP, 4), ("configs/instant_ngp_tpu_occ13_qh.json", 4), ("tiny", 0),
])
def test_jax_ngp_init_is_bit_equal(name, seed):
    """``init_params(PRNGKey(1000 * s))``, leaf for leaf, float32, and the
    port pipeline takes it through ``params_from_jax``."""
    if name == "tiny":
        pipeline_config, dataset_config = jax_entry._tiny_ngp_config(), jax_entry.DATASET_CONFIG
    else:
        config = jax_load_config(str(REPO / name))
        pipeline_config, dataset_config = config["pipeline"], config["dataset"]
    jds = _small_jax_dataset(dataset_config)
    want = JaxPipeline(pipeline_config, jds).init_params(jax.random.PRNGKey(1000 * seed))
    got = convert.jax_ngp_init(pipeline_config, 1000 * seed)
    wl, wt = jax.tree_util.tree_flatten(want)
    gl, gt = jax.tree_util.tree_flatten(got)
    assert wt == gt
    for w, g in zip(wl, gl):
        assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w))
    tds = HARP2Dataset(dataset_config, make_synthetic_granule(height=12, width=8, views_per_band=2),
                       device="cpu", ray_builder=twgs84.get_rays)
    pipe = get_pipeline(copy.deepcopy(pipeline_config), tds, device="cpu")
    pipe.load_params(convert.params_from_jax(got))
    assert torch.equal(pipe.pos_table, torch.from_numpy(np.asarray(want["pos_table"])))


# -- the same init through both packages' steps -----------------------------------------------


def _q8_xla_dispatch(table, x, cfg, sr_noise=None, tiles=None):
    """The q8 forward as JAX computes it on the TPU: per level the int8
    quantization (stochastic rounding where ``sr_noise`` is given), then
    the gather over the dequantized table."""
    assert cfg.fwd_mode == "q8"
    parts = []
    for level in range(cfg.n_levels):
        q, s = quantize_level_q8(table, cfg.level_offsets[level], cfg.level_sizes[level], sr_noise)
        parts.append(q.astype(jnp.float32) * s)
    return jhg._hash_encode_impl(jnp.concatenate(parts, axis=0), x, cfg, tiles)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def same_init_run(config: dict, seed: int, steps: int, batch: int, granule: dict) -> dict:
    """``steps`` train steps of each package from JAX's
    ``init_params(PRNGKey(1000 * seed))``, bf16 MLP products in both, the
    config's optimizer at its lr, one float64 preprocessor shared, the same
    index vectors, forward draws and occupancy jitter (made from JAX keys,
    the refresh after every ``update_every``-th step). Returns both
    packages' per-step losses and branch gradient norms (the tool's five,
    before the clip)."""
    opt_cfg = dict(config["trainer"]["optimizer"])
    lr = float(opt_cfg["lr"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhg, "_fwd_dispatch", _q8_xla_dispatch)
        jds = JaxHARP2Dataset(config["dataset"], jax_granule(**granule),
                              ray_builder=lambda *a, **k: jwgs84.get_rays(*a, **k, xp=np))
        jpipe = JaxPipeline(config["pipeline"], jds)
        assert jpipe.compute_dtype == jnp.bfloat16
        params = jpipe.init_params(jax.random.PRNGKey(1000 * seed))
        tds = HARP2Dataset(config["dataset"], make_synthetic_granule(**granule), device="cpu",
                           ray_builder=twgs84.get_rays)
        tpipe = get_pipeline(copy.deepcopy(config["pipeline"]), tds, device="cpu")
        assert tpipe.compute_dtype == torch.bfloat16
        tpipe.load_params(convert.params_from_jax(convert.jax_ngp_init(config["pipeline"], 1000 * seed)))
        _share_preprocessor(jpipe, tpipe, jds.scene_transform)
        jopt = jpipe.make_optimizer(opt_cfg, lr)
        topt = tpipe.make_optimizer(opt_cfg, lr)
        every = jpipe.occ_cfg.update_every
        opt_state, aux = jopt.init(params), jpipe.init_aux()
        jrays = {k: jnp.asarray(v) for k, v in tds.host_rays().items()}
        names = list(convert.params_from_jax(params))
        groups = [collapse.BRANCHES.index(k.split(".")[0]) for k in names]

        def branch_norms(sq):
            return np.sqrt(np.bincount(groups, weights=sq, minlength=len(collapse.BRANCHES)))

        @jax.jit
        def jstep(params, opt_state, aux, idx, key):
            b = {k: v[idx] for k, v in jrays.items()}

            def loss_fn(p):
                return jpipe.compute_loss(b, jpipe.forward(p, b, key=key, aux=aux))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            sq = jnp.stack([jnp.sum(jnp.square(g)) for g in convert_leaves(grads)])
            updates, opt_state = jopt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss, sq

        def convert_leaves(tree):  # the leaves in params_from_jax's order
            leaves = [tree["pos_table"]]
            for name in ("pos_mlp", "dir_mlp", "surf_mlp"):
                leaves += [layer["w"] for layer in tree[name]["layers"]]
            leaves += [s["hash_table"] for s in tree["surf_enc"] if "hash_table" in s]
            return leaves

        tparams = dict(tpipe.named_parameters())
        rng = np.random.default_rng(1000 * seed + 2)
        base, aux_key = jax.random.split(jax.random.PRNGKey(1000 * seed + 1))
        out = {"jloss": [], "tloss": [], "jnorms": [], "tnorms": []}
        for s in range(steps):
            idx = rng.permutation(len(tds))[:batch]
            key = jax.random.fold_in(base, s)
            params, opt_state, jloss, jsq = jstep(params, opt_state, aux, jnp.asarray(idx), key)
            draws = {k: _t(v) for k, v in _jax_draws(key, jpipe, params, batch).items()}
            tb = {k: _t(v[idx]) for k, v in tds.host_rays().items()}
            topt.zero_grad()
            tloss = tpipe.compute_loss(tb, tpipe(tb, draws=draws))
            tloss.backward()
            tsq = np.array([float(tparams[k].grad.double().square().sum()) for k in names])
            topt.step()
            if (s + 1) % every == 0:
                k_aux = jax.random.fold_in(aux_key, s)
                aux = jpipe.update_aux(params, aux, k_aux)
                tpipe.update_aux(jitter=_t(jax.random.uniform(k_aux, (jpipe.occ_cfg.num_cells, 3))))
            out["jloss"].append(float(jloss))
            out["tloss"].append(float(tloss))
            out["jnorms"].append(branch_norms(np.asarray(jsq, np.float64)))
            out["tnorms"].append(branch_norms(tsq))
    return {k: np.array(v) for k, v in out.items()}


SMALL_STEPS = 24


@pytest.fixture(scope="module")
def small_run():
    config = _small_config("q8")
    config["trainer"] = {"optimizer": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1e-15,
                                       "weight_decay": 0.01, "clip_global_norm": 1.0}}
    with one_torch_thread():
        return same_init_run(config, 4, SMALL_STEPS, 48,
                             {"height": 16, "width": 8, "views_per_band": 2})


def test_same_init_losses_stay_in_an_envelope(small_run):
    """24 steps at bf16 products from JAX's seed-4 init on the same draws:
    the first loss to rtol 5e-4 (measured 3.8e-6: the bf16 products round
    differently in the two packages' matmuls), every later one within 3% of
    JAX's plus 2e-3 (measured 0.71%: each package steps from its own
    parameters, and with eps 1e-15 an update is ``lr * sign(g)``, so an
    element whose tiny gradient differs in sign moves the two apart by 2
    lr); both fall by more than half."""
    j, t = small_run["jloss"], small_run["tloss"]
    assert np.all(np.isfinite(j)) and np.all(np.isfinite(t))
    np.testing.assert_allclose(t[0], j[0], rtol=5e-4)
    assert np.all(np.abs(t - j) <= 0.03 * np.abs(j) + 2e-3), np.abs(t - j) / np.abs(j)
    assert t[-4:].mean() < 0.5 * t[:4].mean() and j[-4:].mean() < 0.5 * j[:4].mean()


def test_same_init_branch_norms_agree_at_the_first_step(small_run):
    """The five branch gradient norms of the first step (same parameters,
    same draws) to rtol 5e-3 (measured 7.6e-4; bf16 products)."""
    np.testing.assert_allclose(small_run["tnorms"][0], small_run["jnorms"][0], rtol=5e-3)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 4])
def test_same_init_outcome_matches_jax_at_full_width(seed):
    """The collapse tool's cell (``instant_ngp_tpu_occ13_q8sr.json``, 96x48
    pixels, one cloud, 8,192 rays) for 200 steps in both packages from
    JAX's init of ``1000 * seed``: the same outcome by the guard's rule
    (mean of the last 5 losses at step 150 against 1.0), and the same
    branch dead or alive at the end. Prints both trajectories' outcome."""
    config = jax_load_config(str(REPO / COLLAPSE_CONFIG))
    run = same_init_run(config, seed, 200, 8192,
                        {"height": 96, "width": 48, "views_per_band": 2, "n_blobs": 1})
    verdicts = {}
    for pkg in ("j", "t"):
        verdicts[pkg] = collapse.outcome(run[f"{pkg}loss"], run[f"{pkg}norms"])
        print(f"seed {seed} {'JAX ' if pkg == 'j' else 'port'}: {verdicts[pkg]}; losses at steps "
              f"1, 10, 50, 100, 150, 200: {run[f'{pkg}loss'][[0, 9, 49, 99, 149, 199]].round(5)}")
    assert verdicts["j"]["collapsed_at_check"] == verdicts["t"]["collapsed_at_check"]
    for branch in ("atmosphere_dead_from", "surface_dead_from"):
        assert (verdicts["j"][branch] is None) == (verdicts["t"][branch] is None), branch


# -- the collapse tool ------------------------------------------------------------------------


def test_outcome_rule():
    """Healthy, collapsed from the start and collapsed late (from step 171);
    a branch whose gradient stays 0 from step 3."""
    steps = 200
    norms = np.ones((steps, 5))
    norms[2:, :3] = 0.0
    healthy = collapse.outcome(np.linspace(3.0, 0.01, steps), np.ones((steps, 5)))
    assert healthy["collapsed_at_check"] is False and healthy["collapsed"] is False
    assert healthy["pinned_from"] is None and healthy["atmosphere_dead_from"] is None
    pinned = collapse.outcome(np.full(steps, 1.6), norms)
    assert pinned["collapsed_at_check"] and pinned["collapsed"] and pinned["pinned_from"] == 5
    assert pinned["atmosphere_dead_from"] == 3 and pinned["surface_dead_from"] is None
    late = np.full(steps, 0.05)
    late[170:] = 1.7
    late_out = collapse.outcome(late, np.ones((steps, 5)))
    assert late_out["collapsed_at_check"] is False and late_out["collapsed"]
    assert late_out["pinned_from"] == 173  # 3 of the 5 at 1.7: a mean of 1.04
    assert collapse.outcome(np.full(3, 2.0), np.ones((3, 5)))["collapsed"] is None


def test_clopper_pearson():
    """Against the beta quantiles of the exact interval (scipy)."""
    stats = pytest.importorskip("scipy.stats")
    for k, n in ((0, 32), (7, 18), (10, 62), (32, 32), (5, 32)):
        lo, hi = collapse.clopper_pearson(k, n)
        want_lo = 0.0 if k == 0 else stats.beta.ppf(0.025, k, n - k + 1)
        want_hi = 1.0 if k == n else stats.beta.ppf(0.975, k + 1, n - k)
        assert abs(lo - want_lo) < 1e-9 and abs(hi - want_hi) < 1e-9
    assert collapse.parse_seeds("0-3,7") == [0, 1, 2, 3, 7]


def test_collapse_tool_runs_on_the_cpu(tmp_path, capsys):
    """Two arms at a few steps on a tiny granule, one call each: a row per
    cell with the trace, the first steps' branch norms and the eval; the JAX
    init arm starts from ``jax_ngp_init``; the products setting is restored
    after."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    out = tmp_path / "rows.jsonl"
    rows = []
    with one_torch_thread():
        for arm in (["init=port", "products=bf16"], ["init=jax", "products=bf16_f32reduce"]):
            rows += collapse.main(
                [f"config={COLLAPSE_CONFIG}", "iters=6", "seed=4", *arm, "mode=eps", f"out={out}"],
                device="cpu", granule={"height": 12, "width": 8, "views_per_band": 2},
                batch_size=32)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == flag
    assert [(r["init"], r["products"], r["seed"]) for r in rows] == [
        ("port", "bf16", 4), ("jax", "bf16_f32reduce", 4)]
    assert len(out.read_text().splitlines()) == 2
    for r in rows:
        assert r["iters"] == 6 and len(r["branch_norms"]) == 6 and r["device"] == "cpu"
        assert [t[0] for t in r["trace"]] == [0, 5] and np.isfinite(r["loss_final"])
        assert r["loss_at_check"] is None and 0.0 < r["ssim"] <= 1.0
    text = capsys.readouterr().out
    assert "iter     0 loss" in text and "branch gradient norms, steps 1-6" in text
    assert "[eps seed=4 init=jax products=bf16_f32reduce]" in text
    with pytest.raises(ValueError):
        collapse.main(["products=fp16"], device="cpu")
    with pytest.raises(ValueError):
        collapse.main(["arms=port:bf16"], device="cpu")
