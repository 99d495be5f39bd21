"""The port's ``graft_entry`` against the root ``__graft_entry__.py``, on the
CPU: ``entry()``'s loss and colors against JAX's ``entry()``, and
``dryrun_multichip(4)`` over four gloo ranks.

JAX's ``entry()`` runs the tiny config's ``auto`` mode; on the TPU that is
the bf16 gather, so the JAX side takes the gather over the bf16-cast table
here (``_tpu_dispatch``, as ``tests/test_torch_configs.py`` does), which the
port's plain version computes on the CPU.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from atmonr_tpu.data.harp2 import HARP2Dataset as JaxHARP2Dataset
from atmonr_tpu.data.synthetic import make_synthetic_granule as jax_granule
from atmonr_tpu.models import hash_grid as jhg
from _torch_threads import one_torch_thread
from _torch_jax_native import jax_native_library  # noqa: F401  (an autouse fixture)
from atmonr_tpu_torch import graft_entry
from test_torch_pipeline import _share_preprocessor


def _tpu_dispatch(table, x, cfg, sr_noise=None, tiles=None):
    assert cfg.fwd_mode == "auto"
    return jhg._hash_encode_impl(table.astype(jnp.bfloat16), x, cfg, tiles)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def entries(request):
    """Both entries' loss and ``color_map_fine``: with float32 MLP products
    and one float64 preprocessor shared (``f32``), or as each package runs
    them, bf16 products and its own float32 preprocessor (``bf16``)."""
    with pytest.MonkeyPatch.context() as mp, one_torch_thread():
        mp.setattr(jhg, "_fwd_dispatch", _tpu_dispatch)
        jfn, (jparams, jbatch) = jax_entry.entry()
        jpipe = inspect.getclosurevars(jfn).nonlocals["pipe"]
        tfn, (tpipe, tbatch) = graft_entry.entry(device="cpu")
        if request.param == "f32":
            jpipe.compute_dtype, tpipe.compute_dtype = jnp.float32, torch.float32
            jds = JaxHARP2Dataset(jax_entry.DATASET_CONFIG,
                                  jax_granule(height=12, width=8, views_per_band=2))
            _share_preprocessor(jpipe, tpipe, jds.scene_transform)
        jloss, jcolor = jfn(jparams, jbatch)
        with torch.no_grad():
            tloss, tcolor = tfn(tpipe, tbatch)
        yield {"mode": request.param, "jparams": jparams, "jbatch": jbatch, "tpipe": tpipe,
               "tbatch": tbatch, "jloss": float(jloss), "tloss": float(tloss),
               "jcolor": np.asarray(jcolor), "tcolor": tcolor.numpy()}


def test_entry_arguments_match_jax(entries):
    """The same 64 rays (the host library is bit-equal to the JAX package's
    native ray build) and the JAX entry's parameters, bit for bit."""
    assert set(entries["tbatch"]) == set(entries["jbatch"])
    for k, v in entries["jbatch"].items():
        assert np.array_equal(entries["tbatch"][k].numpy(), np.asarray(v)), k
    assert entries["tbatch"]["origin"].shape == (graft_entry.ENTRY_RAYS, 3)
    state = dict(entries["tpipe"].named_parameters())
    assert np.array_equal(state["pos_table"].detach().numpy(),
                          np.asarray(entries["jparams"]["pos_table"]))
    assert np.array_equal(state["surf_mlp.layers.2.weight"].detach().numpy(),
                          np.asarray(entries["jparams"]["surf_mlp"]["layers"][2]["w"]))


def test_entry_forward_matches_jax(entries):
    """Loss and (64, 4) colors: with float32 products and the shared
    preprocessor to rtol 1e-5 plus 2e-6 of the largest color (the largest
    difference measured: 8.4e-7 of it); as each package runs it, to rtol
    1e-3 plus 1e-4 of the largest (measured 3.1e-6): bf16 products round
    in different orders, and the two float32 preprocessors differ by ulps
    of the CPU's sin/cos."""
    rtol, atol = (1e-5, 2e-6) if entries["mode"] == "f32" else (1e-3, 1e-4)
    j, t = entries["jcolor"], entries["tcolor"]
    assert t.shape == j.shape == (graft_entry.ENTRY_RAYS, 4) and np.all(np.isfinite(t))
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol * np.abs(j).max())
    np.testing.assert_allclose(entries["tloss"], entries["jloss"], rtol=rtol)


def test_entry_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(1)


def test_dryrun_multichip_over_four_gloo_ranks(capsys):
    """The three modes finish on four ranks: mesh (data 2, sample 2) with the
    occupancy grid and a finite loss, the same on every rank; NeRF on data
    = 4 for 2 iterations; two granule groups of 2 ranks, 2 iterations
    each. The JAX dry run's three lines, in order."""
    ranks = graft_entry.dryrun_multichip(4, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun_multichip")]
    assert len(lines) == 3
    assert re.fullmatch(r"dryrun_multichip OK: mesh=\(data=2, sample=2\), batch=16, "
                        r"occupancy=on, loss=\d+\.\d{5}", lines[0])
    assert lines[1] == "dryrun_multichip OK: NeRF mesh=(data=4), batch=32"
    assert lines[2] == "dryrun_multichip OK: multi-granule groups=[2, 2], pipelines=InstantNGP"
    step_losses = [r["sharded_step"]["losses"] for r in ranks]
    assert np.all(np.isfinite(step_losses)) and all(s == step_losses[0] for s in step_losses)
    for r in ranks:
        assert r["nerf"]["iter_count"] == 2 and np.isfinite(r["nerf"]["loss"])
        assert r["granules"]["groups"] == [2, 2] and r["granules"]["iter_counts"] == [2]
        assert np.all(np.isfinite(r["granules"]["losses"]))
        assert not any(r["launches"]["K1"].values())  # CPU tensors take the plain versions
