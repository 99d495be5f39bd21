"""The port's headline bench (``atmonr_tpu_torch/bench.py``) against the
JAX repo's ``bench.py``, on the CPU.

Four steps of the bench's step (``Trainer.step`` on the bench's trainer
block, ``bench.trainer_config``) against the same composition of the JAX
package's pieces as ``bench.py``'s ``train_step`` and ``maybe_refresh_occ``:
``batch_at_step`` over the rays, the forward with the draws of
``fold_in(PRNGKey(2), step)``, ``compute_loss``, ``value_and_grad``, the
pipeline's ``make_optimizer`` at a constant lr of 1e-2, and the occupancy
refresh every ``update_every`` steps with the jitter of
``fold_in(PRNGKey(3), step)``. Both start from the same parameters
(``convert.params_from_jax``, loaded into the Trainer's pipeline) and
occupancy grid, take the same rows and the same draws:
``tests/test_torch_train.py``'s ``pair`` fixture (the small config, float32
MLP products, ``"xla"`` and ``"q8"``) and ``_jax_draws``, at that file's
tolerances for a few Trainer steps (stated on each test). Then ``main`` on
the CPU at a tiny size prints ``bench.py``'s JSON line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atmonr_tpu.data import batching as jbatching
from atmonr_tpu_torch import Trainer, bench, convert
from test_torch_pipeline import N_RAYS
from test_torch_train import OPTIMIZER, _jax_draws, _t, _trainer_config, pair  # noqa: F401

N_STEPS = 4
LR = 1e-2


@pytest.fixture(scope="module")
def bench_run(pair, tmp_path_factory):  # noqa: F811
    jpipe, tpipe, tds = pair["jpipe"], pair["tpipe"], pair["tds"]
    params, aux = pair["params"], pair["aux"]
    every = jpipe.occ_cfg.update_every
    assert every == 2 and tpipe.occ_cfg.update_every == every
    perm = np.random.default_rng(8).permutation(len(tds))[: 2 * N_RAYS]
    jrays = {k: jnp.asarray(v) for k, v in tds.host_rays().items()}

    jopt = jpipe.make_optimizer(OPTIMIZER, LR)
    opt_state = jopt.init(params)
    state = {k: v.clone() for k, v in tpipe.state_dict().items()}  # parameters and grid
    trainer = Trainer(bench.trainer_config(_trainer_config(), N_RAYS), tds, tpipe, "bench",
                      tmp_path_factory.mktemp("bench"), device="cpu")
    tpipe.load_state_dict(state)
    assert trainer.batch_size == N_RAYS and not trainer.progress
    spe = len(perm) // N_RAYS

    @jax.jit
    def train_step(params, opt_state, aux, i, step):
        """bench.py's ``train_step`` (the state's pieces as arguments)."""
        batch = jbatching.batch_at_step(jrays, jnp.asarray(perm), i, N_RAYS)
        key = jax.random.fold_in(jax.random.PRNGKey(2), step)

        def loss_fn(p):
            return jpipe.compute_loss(batch, jpipe.forward(p, batch, key, aux=aux))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    steps = []
    for step in range(N_STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(2), step)
        params, opt_state, jloss, jgrads = train_step(params, opt_state, aux, step % spe, step)
        # bench.py's maybe_refresh_occ
        k_aux = jax.random.fold_in(jax.random.PRNGKey(3), step)
        if (step + 1) % every == 0:
            aux = jpipe.update_aux(params, aux, k_aux)

        draws = {k: _t(v) for k, v in _jax_draws(key, jpipe, params, N_RAYS).items()}
        jitter = _t(jax.random.uniform(k_aux, (jpipe.occ_cfg.num_cells, 3)))
        slot = step % spe
        tloss = trainer.step(torch.from_numpy(perm[slot * N_RAYS : (slot + 1) * N_RAYS]),
                             draws=draws, aux_jitter=jitter)
        steps.append({
            "jloss": float(jloss), "tloss": float(tloss),
            "jgrads": convert.params_from_jax(jgrads),
            "jparams": convert.params_from_jax(params),
            "tparams": {k: v.detach().clone() for k, v in tpipe.named_parameters()},
            "jocc": np.asarray(aux["occ"]), "tocc": tpipe.occ.clone().numpy(),
        })
    return {"steps": steps, "optimizer": trainer.optimizer}


def test_bench_step_losses_match_jax(bench_run):
    """Every step's loss to rtol 1e-4 (``test_trainer_losses_match_jax``'s
    tolerance): from the second step on each package computes it from
    parameters it updated itself. One optimizer update a step."""
    for s in bench_run["steps"]:
        assert np.isfinite(s["tloss"])
        np.testing.assert_allclose(s["tloss"], s["jloss"], rtol=1e-4)
    assert bench_run["optimizer"].count == N_STEPS


def test_bench_step_parameters_match_jax(bench_run):
    """Parameters after the four steps, where every step's gradient cleared
    1e-3 of the tensor's largest or was exactly zero: rtol 1e-3 plus 1e-3 of
    the largest parameter (``test_trainer_parameters_match_jax``'s rule:
    under eps = 1e-15 a tiny gradient's sign decides a full lr step)."""
    steps = bench_run["steps"]
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
        assert bool(((last["tparams"][k] - jp).abs() <= tol)[clear].all()), k


def test_bench_step_refreshes_the_grid_as_jax(bench_run):
    """The grid changes after steps 2 and 4 only, and then agrees with
    JAX's to rtol 1e-3 plus 1e-6 (``test_trainer_occupancy_refresh_matches_jax``)."""
    steps = bench_run["steps"]
    assert np.array_equal(steps[0]["tocc"], steps[1]["tocc"]) is False
    assert np.array_equal(steps[1]["tocc"], steps[2]["tocc"]) is True
    assert np.array_equal(steps[2]["tocc"], steps[3]["tocc"]) is False
    for s in steps:
        np.testing.assert_allclose(s["tocc"], s["jocc"], rtol=1e-3, atol=1e-6)


def test_bench_main_prints_the_bench_line(capsys):
    """``main`` on the CPU at a tiny size: provisional lines (one a warm-up
    block, one after the provisional window), then the final line with
    ``bench.py``'s four keys, and the device it ran on."""
    rays_per_s = bench.main(device="cpu", batch_size=64,
                            granule={"height": 8, "width": 6, "views_per_band": 2},
                            warmup_block=2, max_warmup_iters=4, provisional_iters=2,
                            timed_iters=2)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    final = lines[-1]
    assert {"metric", "value", "unit", "vs_baseline"} <= set(final)
    assert final["metric"] == "instant_ngp_train_rays_per_s_per_chip"
    assert final["unit"] == "rays/s" and final["device"] == "cpu"
    assert "provisional" not in final
    assert final["value"] == round(rays_per_s, 1) > 0
    assert final["vs_baseline"] == round(rays_per_s / 1e5, 3)
    assert all(x.get("provisional") for x in lines[:-1])
    assert len(lines) >= 3 and lines[0]["source"] == "warmup block"
