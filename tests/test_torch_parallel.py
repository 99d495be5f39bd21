"""The port's multi-device path against the JAX package, on the CPU: mesh
specs and each data index's rows, the sample-sharded compositor, the
data-sharded forward and loss (Instant-NGP and NeRF), the sample-sharded
Instant-NGP forward with the occupancy grid, their gradients, and
``Trainer.shard``.

The port runs in spawned gloo ranks (``tests/_torch_ranks.py``); the JAX
package on the 8 virtual CPU devices of ``tests/conftest.py``, under
``jax.jit`` (its ``shard_map`` is op-by-op outside it). Both get the same
parameters (``convert.params_from_jax``), the first 64 rays of the same
granule and float32 MLP products; the configs are
``tests/test_torch_pipeline.py``'s small Instant-NGP without a point
preprocessor (its float32 transcendentals differ by ulps between XLA:CPU and
torch) and ``tests/test_torch_nerf.py``'s golden NeRF config. Forwards are
deterministic (no key, no draws). Each spawn serves several tests.
"""

import copy
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_ranks as ranks
from atmonr_tpu.parallel import data as jdata
from atmonr_tpu.parallel.mesh import make_mesh as jmake_mesh
from atmonr_tpu.parallel.mesh import make_mesh_from_spec as jmesh_from_spec
from atmonr_tpu.parallel.sharding import render_sample_sharded as jrender_sharded
from atmonr_tpu.parallel.sharding import replicate as jreplicate
from atmonr_tpu.parallel.train import forward_loss_data_sharded as jfwd_data
from atmonr_tpu.parallel.train import ngp_forward_sample_sharded as jfwd_sample
from atmonr_tpu.pipelines import get_pipeline as jget_pipeline
from atmonr_tpu_torch import convert
from atmonr_tpu_torch.ops import compositor
from atmonr_tpu_torch.parallel import data as tdata
from atmonr_tpu_torch.parallel.mesh import parse_mesh_spec
from test_torch_nerf import GOLDEN_CONFIG
from test_torch_pipeline import _config, _jax_dataset
from test_torch_train import _trainer_config

B = 64  # rays per batch: whole shares at 2 and 4 data indices
REPO = Path(__file__).resolve().parent.parent


def _ngp_config(occupancy: bool) -> dict:
    config = _config("xla")
    config["pipeline"]["point_preprocessor"] = None
    if occupancy:
        config["pipeline"]["occupancy"]["n_fine"] = 8  # splits over 2 and 4
    else:
        del config["pipeline"]["occupancy"]
    return config


def _nerf_config() -> dict:
    return {"dataset": _config("xla")["dataset"], "pipeline": dict(GOLDEN_CONFIG)}


@pytest.fixture(scope="module")
def jds():
    return _jax_dataset(_config("xla"))


@pytest.fixture(scope="module")
def rays(jds):
    return {k: v[:B] for k, v in jds.host_rays().items()}


def _jax_pipe(config, jds, seed=1):
    pipe = jget_pipeline(copy.deepcopy(config["pipeline"]), jds)
    pipe.compute_dtype = jnp.float32
    return pipe, pipe.init_params(jax.random.PRNGKey(seed))


def _np_params(params) -> dict:
    return {k: v.numpy() for k, v in convert.params_from_jax(params).items()}


def _sharded(batch, mesh):
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
            for k, v in batch.items()}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) or 1.0))


def test_the_port_imports_nothing_of_jax():
    """No module of ``atmonr_tpu_torch`` has an import statement naming
    jax, optax or atmonr_tpu, and importing the multi-device modules pulls
    none of them in."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax|atmonr_tpu)(\s|\.|$)", re.M)
    sources = list((REPO / "atmonr_tpu_torch").rglob("*.py"))
    assert len(sources) > 40
    assert [str(p) for p in sources if pattern.search(p.read_text())] == []
    code = (
        "import sys, atmonr_tpu_torch.parallel, atmonr_tpu_torch.training.multi\n"
        "import atmonr_tpu_torch.scripts.extract, atmonr_tpu_torch.extract.runner\n"
        "bad = [m for m in sys.modules if m in ('jax', 'optax', 'atmonr_tpu')\n"
        "       or m.startswith(('jax.', 'optax.', 'atmonr_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert 'atmonr_tpu_torch.parallel.sharding' in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)


# -- meshes and rows ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_spec_and_ray_rows_match_jax(shape):
    """``parse_mesh_spec`` gives JAX's mesh shapes; ``data_rows`` gives each
    data index the rows that JAX's ``NamedSharding(mesh, P("data"))`` gives
    its devices, over the count JAX's ``trimmed_ray_count`` trims to."""
    data, sample = shape
    jmesh = jmake_mesh(data=data, sample=sample)
    spec = f"data={data},sample={sample}"
    assert dict(jmesh_from_spec(spec).shape) == {"data": data, "sample": sample}
    assert parse_mesh_spec(spec) == (data, sample)
    assert parse_mesh_spec(f"sample={sample}") == (None, sample)
    with pytest.raises(ValueError, match="axis"):
        parse_mesh_spec("model=2")
    for n_total in (1013, 1024, 7 + data):
        n = jdata.trimmed_ray_count(n_total, jmesh)
        index_map = NamedSharding(jmesh, P("data")).devices_indices_map((n,))
        for d in range(data):
            for s in range(sample):
                js = index_map[jmesh.devices[d, s]][0]
                got = tdata.data_rows(n_total, data, d)
                assert (got.start, got.stop) == (js.start or 0, n if js.stop is None else js.stop)
        assert tdata.data_rows(n_total, data, data - 1).stop == n


# -- the sample-sharded compositor ---------------------------------------------------------


@pytest.fixture(scope="module")
def render_run(tmp_path_factory):
    """One 4-rank spawn: mesh 1x4 and mesh 2x2 on the same seeded rays."""
    rng = np.random.default_rng(0)
    b, n, c = 8, 32, 4
    inputs = {
        "z": np.sort(rng.uniform(0, 20, (b, n)).astype(np.float32), axis=-1),
        "color": rng.uniform(size=(b, n, c)).astype(np.float32),
        "sigma": (rng.uniform(size=(b, n, c)) * 0.3).astype(np.float32),
        "w_color": rng.normal(size=(b, c)).astype(np.float32),
        "w_trans": rng.normal(size=(b, c)).astype(np.float32),
    }
    out = ranks.spawn(4, tmp_path_factory.mktemp("render"), ranks.render_ranks, *inputs.values())
    return inputs, out


@pytest.mark.parametrize("ns", [2, 4])
def test_render_sample_sharded_matches_jax(render_run, ns):
    """Outputs against JAX's ``render_sample_sharded`` at its bounds
    (``tests/test_parallel.py``); the gradients of a loss of the color map
    and the total transmittance with respect to color and sigma, summed over
    the sample ranks, against the single-device ``ops/compositor.render``
    to rtol 1e-5 plus 1e-7 of the largest (float32 sums in another order).
    At ns = 2 both data rows of the 2x2 mesh do it."""
    inputs, out = render_run
    z, color, sigma = (jnp.asarray(inputs[k]) for k in ("z", "color", "sigma"))
    jmesh = jmake_mesh(data=1, sample=ns)
    jcm, jtrans, jalpha, jw = jax.jit(lambda *a: jrender_sharded(*a, jmesh))(z, color, sigma)

    c = torch.from_numpy(inputs["color"]).requires_grad_()
    s = torch.from_numpy(inputs["sigma"]).requires_grad_()
    cm, alpha, _ = compositor.render(torch.from_numpy(inputs["z"]), c, s)
    trans = torch.prod(1.0 - alpha, dim=1)
    loss = (cm * torch.from_numpy(inputs["w_color"])).sum() + (
        trans * torch.from_numpy(inputs["w_trans"])).sum()
    g_color, g_sigma = torch.autograd.grad(loss, [c, s])

    groups = [out[:4]] if ns == 4 else [out[:2], out[2:]]
    for group in groups:
        runs = [r[ns] for r in group]
        assert [r["coord"][1] for r in runs] == list(range(ns))
        for r in runs:
            np.testing.assert_allclose(r["color_map"], np.asarray(jcm), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(r["trans_total"], np.asarray(jtrans), rtol=1e-5, atol=1e-7)
        alpha_all = np.concatenate([r["alpha"] for r in runs], axis=1)
        w_all = np.concatenate([r["weights"] for r in runs], axis=1)
        np.testing.assert_allclose(alpha_all, np.asarray(jalpha), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(w_all, np.asarray(jw), rtol=1e-4, atol=1e-7)
        for key, want in (("g_color", g_color), ("g_sigma", g_sigma)):
            got = sum(r[key] for r in runs)
            want = want.numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())


# -- the data-sharded forward, loss and gradients ----------------------------------------


@pytest.fixture(scope="module")
def data_run(jds, rays, tmp_path_factory):
    """One 4-rank spawn: data = 4 and data = 2 for Instant-NGP and NeRF."""
    cases = {}
    for name, config in (("ngp", _ngp_config(False)), ("nerf", _nerf_config())):
        pipe, params = _jax_pipe(config, jds)
        cases[name] = (config, pipe, params)
    port_cases = {k: (cfg, _np_params(p)) for k, (cfg, _, p) in cases.items()}
    out = ranks.spawn(4, tmp_path_factory.mktemp("data"), ranks.data_sharded_ranks,
                      port_cases, rays)
    return cases, out


def _data_ranks(out, name: str, d: int) -> list[dict]:
    """The ranks of one mesh of ``d`` data indices, in data order."""
    return [r[(name, d)] for r in out[:d]]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", ["ngp", "nerf"])
def test_forward_loss_data_sharded_matches_jax(data_run, rays, name, d):
    """Each rank's loss (the mean over "data") against JAX's
    ``forward_loss_data_sharded`` on a mesh of ``d`` data indices to rtol
    1e-5; the ranks' outputs, stacked in data order, against JAX's to rtol
    1e-4 / atol 1e-5 (JAX's bounds for its sharded-vs-unsharded check)."""
    cases, out = data_run
    _, pipe, params = cases[name]
    jmesh = jmake_mesh(data=d, sample=1)
    jloss, jout = jax.jit(lambda p, b: jfwd_data(pipe, p, b, jmesh, key=None))(
        jreplicate(params, jmesh), _sharded(rays, jmesh))
    runs = _data_ranks(out, name, d)
    assert [r["rows"] for r in runs] == [(i * B // d, (i + 1) * B // d) for i in range(d)]
    for r in runs:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
    assert set(runs[0]["results"]) == set(jout), (set(runs[0]["results"]) ^ set(jout))
    for key, want in jout.items():
        got = np.concatenate([r["results"][key] for r in runs], axis=0)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("d", [2, 4])
def test_data_sharded_gradients_match_jax(data_run, rays, d):
    """Instant-NGP's gradients after ``reduce_gradients`` against JAX's
    unsharded ``jax.grad`` (jitted): per tensor, relative L2 below 1e-3
    (JAX's bound, ``tests/test_parallel.py``); every rank holds the same
    gradient, bit for bit."""
    cases, out = data_run
    _, pipe, params = cases["ngp"]
    batch = {k: jnp.asarray(v) for k, v in rays.items()}

    def loss(p):
        return pipe.compute_loss(batch, pipe.forward(p, batch, key=None))

    want = {k: v.numpy() for k, v in convert.params_from_jax(jax.jit(jax.grad(loss))(params)).items()}
    runs = _data_ranks(out, "ngp", d)
    assert set(runs[0]["grads"]) == set(want)
    for name, w in want.items():
        assert _rel_l2(runs[0]["grads"][name], w) < 1e-3, name
        for r in runs[1:]:
            np.testing.assert_array_equal(r["grads"][name], runs[0]["grads"][name], err_msg=name)


# -- the sample-sharded Instant-NGP forward --------------------------------------------------


@pytest.fixture(scope="module")
def sample_run(jds, rays, tmp_path_factory):
    """One 4-rank spawn: mesh 2x2 and mesh 1x4 with the occupancy grid
    refreshed as JAX refreshes it."""
    config = _ngp_config(True)
    pipe, params = _jax_pipe(config, jds)
    k_occ = jax.random.PRNGKey(5)
    aux = pipe.update_aux(params, pipe.init_aux(), k_occ)
    jitter = np.asarray(jax.random.uniform(k_occ, (pipe.occ_cfg.num_cells, 3)))
    out = ranks.spawn(4, tmp_path_factory.mktemp("sample"), ranks.sample_sharded_ranks,
                      config, _np_params(params), jitter, rays)
    return config, pipe, params, aux, jitter, out


def _assemble(out, shape, key, sample_axis: bool):
    """A result of the ranks of mesh ``shape``: the rows of the data
    indices stacked; along the samples the slices concatenated."""
    nd, ns = shape
    by_coord = {tuple(r[shape]["coord"]): r[shape] for r in out}
    rows = []
    for d in range(nd):
        parts = [by_coord[(d, s)]["results"][key] for s in range(ns)]
        if sample_axis:
            rows.append(np.concatenate(parts, axis=1))
        else:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0], err_msg=key)
            rows.append(parts[0])
    return np.concatenate(rows, axis=0)


def test_sample_sharded_forward_matches_jax(sample_run, rays):
    """Mesh 2x2 against JAX's ``ngp_forward_sample_sharded`` on a 2x2 mesh,
    deterministic, with the same occupancy grid: color maps to rtol 1e-4 /
    atol 1e-5 (JAX's bounds), the same on both sample ranks of a row, and
    the weights' slices."""
    config, pipe, params, aux, _, out = sample_run
    jmesh = jmake_mesh(data=2, sample=2)
    jout = jax.jit(lambda p, b, a: jfwd_sample(pipe, p, b, jmesh, key=None, aux=a))(
        jreplicate(params, jmesh), _sharded(rays, jmesh), jreplicate(aux, jmesh))
    assert set(out[0][(2, 2)]["results"]) == set(jout)
    for key, want in jout.items():
        got = _assemble(out, (2, 2), key, sample_axis=key == "weights_fine")
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["data2_sample2", "sample4"])
def test_sample_sharded_gradients_match_unsharded(sample_run, rays, shape):
    """The gradients that the collectives' backward rules and
    ``reduce_gradients`` give (volume branch summed over "sample", surface
    branch not, all summed over the data shares) against the port's
    unsharded forward on the whole batch: per tensor, relative L2 below
    1e-3; every rank holds the same gradient and loss, bit for bit; the
    loss to rtol 1e-5."""
    config, _, params, _, jitter, out = sample_run
    pipe = ranks.port_pipeline(config, _np_params(params), jitter)
    batch = {k: torch.from_numpy(v) for k, v in rays.items()}
    loss = pipe.compute_loss(batch, pipe(batch))
    loss.backward()
    loss = float(loss.detach())
    want = {n: p.grad.numpy() for n, p in pipe.named_parameters()}
    runs = [r[shape] for r in out]
    for r in runs[1:]:
        assert r["loss"] == runs[0]["loss"]
    np.testing.assert_allclose(runs[0]["loss"], loss, rtol=1e-5)
    for name, w in want.items():
        assert _rel_l2(runs[0]["grads"][name], w) < 1e-3, (name, _rel_l2(runs[0]["grads"][name], w))
        for r in runs[1:]:
            np.testing.assert_array_equal(r["grads"][name], runs[0]["grads"][name], err_msg=name)


def test_sharded_train_step_reduces_the_loss(sample_run):
    """``make_ngp_sharded_train_step`` on mesh 2x2, eight steps of 32 rays
    a data index with AdamW (JAX's ``test_sharded_train_step_runs_and_
    reduces_loss``): finite losses, the last below the first, the same on
    every rank, and bitwise-equal parameters and grid on every rank."""
    out = sample_run[-1]
    runs = [r["train_step"] for r in out]
    losses = runs[0]["losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    for r in runs[1:]:
        assert r["losses"] == losses
        for k, v in runs[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


# -- Trainer.shard --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    """One 4-rank spawn, two Trainers at once: ranks 0-1 on data=2, ranks
    2-3 on data=1,sample=2 (``_torch_ranks.trainer_ranks``)."""
    root = tmp_path_factory.mktemp("trainer")
    config = dict(_config("xla"), trainer=_trainer_config(batch_size=256, num_iters=12))
    config["pipeline"]["occupancy"]["update_every"] = 2
    out = ranks.spawn(4, root, ranks.trainer_ranks, config, _nerf_config(), str(root))
    return root, out


@pytest.mark.parametrize("group", [0, 1], ids=["data2", "data1_sample2"])
def test_trainer_shard_trains_the_same_model_on_every_rank(trainer_run, group):
    """A few steps over three epochs: both ranks end with bitwise-equal
    parameters, occupancy grids and moments and the same losses, which
    fall; the data indices hold contiguous halves of the trimmed rays (as
    ``shard_rays`` cuts them) and the sample ranks the same rows;
    ``replicate`` gives every rank the first rank's tensor; one
    ``metrics.jsonl`` is written; a
    fresh Trainer loads the latest checkpoint to the same state on every
    rank, with each data index's own draws stream."""
    root, out = trainer_run
    a, b = out[2 * group : 2 * group + 2]
    assert a["group"] == b["group"] == group
    n, n_trim = a["n_rays"], a["n_trim"]
    if group == 0:
        assert n_trim == n - n % 2
        assert (a["slice"], b["slice"]) == ((0, n_trim // 2), (n_trim // 2, n_trim))
        assert a["rank_batch"] == b["rank_batch"] == a["batch_size"] // 2
        assert not np.array_equal(a["draws_state"], b["draws_state"])
    else:
        assert a["slice"] == b["slice"] == (0, n)
        assert a["rank_batch"] == a["batch_size"]
        np.testing.assert_array_equal(a["draws_state"], b["draws_state"])
    assert a["same_rows"] and b["same_rows"]  # shard_rays: the Trainer's rows
    assert a["replicated"] == b["replicated"] == [2.0 * group] * 3  # the mesh's first rank's
    assert a["iter_count"] == 12 and a["epoch_idx"] >= 3
    assert (a["is_main"], b["is_main"]) == (True, False)
    assert a["losses"] == b["losses"] and np.all(np.isfinite(a["losses"]))
    assert np.mean(a["losses"][-3:]) < np.mean(a["losses"][:3])
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)
        for r in (a, b):
            np.testing.assert_array_equal(r["loaded"][k], a["state"][k], err_msg=k)
    for x, y in zip(a["moments"], b["moments"]):
        np.testing.assert_array_equal(x, y)
    assert a["loaded_iter"] == b["loaded_iter"] == 12
    # the resumed Trainer's own (empty) log aside, one log, one line each
    logs = [p for p in (root / f"group{group}" / "tensorboard").glob("*/metrics.jsonl")
            if p.stat().st_size]
    assert len(logs) == 1
    lines = [json.loads(line) for line in logs[0].read_text().splitlines()]
    assert len({(r["tag"], r["step"]) for r in lines}) == len(lines)
    assert {"Loss", "PSNR_mean"} <= {r["tag"] for r in lines}


def test_trainer_shard_refuses_what_jax_refuses(trainer_run):
    """NeRF with a "sample" axis over 1 is refused (a data-only mesh takes
    it), and so is ``check_numerics`` under a mesh."""
    _, out = trainer_run
    for r in out:
        assert "check_numerics" in r["refused"]["check_numerics"]
    assert "nerf" not in out[0]["refused"] and "nerf" not in out[1]["refused"]
    for r in out[2:]:
        assert "sample" in r["refused"]["nerf"]
