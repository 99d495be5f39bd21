"""The port's quality harness (``atmonr_tpu_torch/tools/ab_importance.py``)
and the tools built on it, on the CPU.

- ``evaluate`` against the JAX tool's eval (``tools/ab_importance.py``'s
  deterministic full-dataset eval, composed here from the JAX package since
  ``tools/`` is not a package: the forward without ``aux`` in jitted slices
  of ``min(b, 4096)`` rays, the tail padded with its last row, each ray's
  color in its own band, ``scatter_image``, ``image_metrics``) on the same
  parameters: ``tests/test_torch_train.py``'s ``pair`` fixture (the small
  config with an occupancy grid, float32 MLP products, one shared float64
  preprocessor; ``"xla"`` and ``"q8"``, the latter through the Pallas kernel
  in interpret mode). Per-ray predictions agree to rtol 1e-4 + 1e-6 of the
  largest (float32 sums in other orders), so PSNR to 1e-3 dB and SSIM to
  1e-5.
- ``run``'s control flow, with ``Trainer.step`` and the clock observed: the
  iteration count, the Trainer's restart guard and what a restart
  re-draws, the epoch permutations of the Trainer's stream, and the stop at
  the first ``SYNC_BLOCK`` edge past the budget.
- ``quality_matrix`` and ``quality_real_scale`` skip a cell their JSONL
  already holds; the real-scale demo runs at 8x6 pixels from a file and
  from memory.
"""

import contextlib
import io
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmonr_tpu.training.metrics import image_metrics as jax_image_metrics
from atmonr_tpu_torch import Trainer
from atmonr_tpu_torch.data.batching import epoch_permutation
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
from atmonr_tpu_torch.tools import ab_importance, quality_matrix, quality_real_scale
from atmonr_tpu_torch.tools import real_scale_demo
from test_torch_pipeline import _config
from test_torch_train import OPTIMIZER, pair  # noqa: F401  (a fixture)

TINY = {"height": 8, "width": 6, "views_per_band": 2}
EVAL_BATCH = 256  # slices of 256 rays and a shorter tail
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


def _jax_eval(jpipe, params, jds, b):
    """``tools/ab_importance.py``'s eval (its lines 160-200) over the JAX
    dataset: slices of ``min(b, 4096)``, the tail padded by repeating its
    last row, ``take_along_axis`` at ``irgb_idx``; returns the per-ray
    predictions and the metrics."""
    rays = jds.rays()
    b_eval = min(b, 4096)

    @jax.jit
    def eval_slice(p, sl):
        out = jpipe.forward(p, sl, key=None)
        return jnp.take_along_axis(out["color_map_fine"], sl["irgb_idx"][:, None], axis=1)[:, 0]

    preds = []
    for s in range(0, jds.num_rays, b_eval):
        sl = {k: v[s:s + b_eval] for k, v in rays.items()}
        tail = sl["origin"].shape[0]
        if tail < b_eval:
            sl = {k: jnp.concatenate([v, jnp.repeat(v[-1:], b_eval - tail, axis=0)], axis=0)
                  for k, v in sl.items()}
        preds.append(np.asarray(eval_slice(params, sl))[:tail])
    preds = np.concatenate(preds)
    return preds, jax_image_metrics(jds.scatter_image(preds), jds.target_image(), jds.max_i)


def test_eval_matches_jax(pair, monkeypatch):  # noqa: F811
    jpipe, tpipe, jds, tds = pair["jpipe"], pair["tpipe"], pair["jds"], pair["tds"]
    assert tds.num_rays == jds.num_rays and tds.num_rays % EVAL_BATCH  # a tail
    jpred, jm = _jax_eval(jpipe, pair["params"], jds, EVAL_BATCH)
    seen = []  # what evaluate scatters: its predictions, then (target_image) the radiances
    real_scatter = tds.scatter_image
    monkeypatch.setattr(tds, "scatter_image", lambda v: seen.append(v) or real_scatter(v))
    tm = ab_importance.evaluate(tpipe, tds, EVAL_BATCH)
    np.testing.assert_allclose(seen[0], jpred, rtol=1e-4, atol=1e-6 * np.abs(jpred).max())
    assert abs(tm["PSNR_mean"] - jm["PSNR_mean"]) <= PSNR_TOL
    assert abs(tm["SSIM_mean"] - jm["SSIM_mean"]) <= SSIM_TOL
    assert ab_importance.eval_slices(tds.num_rays, EVAL_BATCH) == -(-tds.num_rays // EVAL_BATCH)


def test_eval_does_not_sample_by_the_grid(pair):  # noqa: F811
    """Without the grid an occupancy config renders ``num_samples_per_ray``
    uniform bins (JAX's forward without ``aux``), whatever the grid holds;
    draws are refused there."""
    tpipe, tds = pair["tpipe"], pair["tds"]
    batch = {k: v[:32] for k, v in tds.rays("cpu").items()}
    n = pair["config"]["pipeline"]["num_samples_per_ray"]
    occ = tpipe.occ.clone()
    with torch.no_grad():
        a = tpipe(batch, use_grid=False)
        tpipe.occ.fill_(1.0)
        b = tpipe(batch, use_grid=False)
        tpipe.occ.copy_(occ)
        c = tpipe(batch)
    assert a["z_vals_fine"].shape == (32, n) and torch.equal(a["color_map_fine"],
                                                             b["color_map_fine"])
    assert c["z_vals_fine"].shape == (32, tpipe.occ_cfg.n_fine)
    with pytest.raises(ValueError, match="deterministic"):
        tpipe(batch, use_grid=False, generator=torch.Generator())


# -- run's control flow --------------------------------------------------------------

RESTART = {"check_iter": 3, "loss_threshold": 1e-9, "max_restarts": 2}
RUN_BATCH = 128
BUDGET = 2.5  # fake seconds: the clock reads t0 + 1, + 2, + 3 at steps 25, 50, 75


@pytest.fixture(scope="module")
def run_trace(tmp_path_factory):
    """One ``run`` of the small config (refresh every 4 steps, a restart
    threshold below any loss) under a clock that advances one second a
    read. Returns the result, the printed text and, per ``Trainer.step``,
    the Trainer's step count, its optimizer, the optimizer's count, the rows
    and whether the occupancy grid was the freshly reset one."""
    config = _config("xla")
    config["pipeline"]["occupancy"]["update_every"] = 4
    config["trainer"] = {"optimizer": dict(OPTIMIZER), "restart_on_plateau": RESTART,
                         "scheduler": {"type": "fixed", "gamma": 1.0, "decay_start": 0,
                                       "decay_interval": 1}}
    path = tmp_path_factory.mktemp("run") / "config.json"
    path.write_text(json.dumps(config))
    calls = []
    real = Trainer.step

    def recording(self, idx, *args, **kwargs):
        calls.append({"i": self.iter_count, "opt": self.optimizer, "count": self.optimizer.count,
                      "rows": idx.clone(), "fresh_grid": bool((self.pipeline.occ == 1.0).all())})
        return real(self, idx, *args, **kwargs)

    ticks = iter(range(1, 1000))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "step", recording)
        mp.setattr(ab_importance, "time",
                   types.SimpleNamespace(perf_counter=lambda: float(next(ticks))))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = ab_importance.run("small", str(path), 1000, seed=1, seconds=BUDGET,
                                       device="cpu", granule=TINY, batch_size=RUN_BATCH)
    return {"result": result, "text": out.getvalue(), "calls": calls}


def test_run_stops_at_the_first_sync_block_past_the_budget(run_trace):
    """Clock reads: t0, then one at each 25-step edge (elapsed 1, 2, 3: the
    third passes 2.5 s), then the end. 75 steps, step 0 before t0."""
    r = run_trace["result"]
    assert [c["i"] for c in run_trace["calls"]] == list(range(75))
    assert r["iters"] == 75 and r["seconds"] == 4.0
    assert r["rays_per_s"] == round(75 * RUN_BATCH / 4.0, 1)
    assert np.isfinite(r["loss"]) and np.isfinite(r["psnr"]) and r["device"] == "cpu"
    assert set(r) == {"name", "seed", "iters", "seconds", "rays_per_s", "loss", "psnr", "ssim",
                      "restarts", "eval_s", "device"}


def test_run_restarts_on_plateau(run_trace):
    """The Trainer's guard: a loss above the threshold at ``check_iter``
    steps after each (re)start re-draws the parameters, the optimizer (count
    0) and the grid, at steps 3 and 6, then stops checking at
    ``max_restarts``."""
    calls = run_trace["calls"]
    assert run_trace["result"]["restarts"] == 2
    assert "[restart 1] loss" in run_trace["text"] and "at iter 3;" in run_trace["text"]
    assert "[restart 2] loss" in run_trace["text"] and "at iter 6;" in run_trace["text"]
    assert run_trace["text"].count("[restart") == 2
    opts = [c["opt"] for c in calls]
    assert opts[0] is opts[2] and opts[3] is not opts[2] and opts[6] is not opts[5]
    assert opts[6] is opts[-1]
    assert [calls[i]["count"] for i in (0, 2, 3, 5, 6, 74)] == [0, 2, 0, 2, 0, 68]
    # a reset grid at each restart; the first refresh comes after step 4
    assert all(c["fresh_grid"] for c in calls[:4]) and calls[6]["fresh_grid"]
    assert not calls[4]["fresh_grid"] and not calls[5]["fresh_grid"]


def test_run_draws_a_permutation_every_epoch(run_trace):
    """The rows are the Trainer's perm stream's permutations, a new one
    before each epoch's first step, as ``Trainer.iterate`` draws them."""
    from atmonr_tpu_torch.training.trainer import _stream_seed

    calls = run_trace["calls"]
    ds = HARP2Dataset(_config("xla")["dataset"], make_synthetic_granule(**TINY), device="cpu")
    spe = ds.num_rays // RUN_BATCH
    assert spe >= 2
    gen = torch.Generator().manual_seed(_stream_seed(1, 1))
    want = [epoch_permutation(gen, ds.num_rays, RUN_BATCH) for _ in range(75 // spe + 1)]
    for c in calls:
        slot = c["i"] % spe
        assert torch.equal(c["rows"], want[c["i"] // spe][slot * RUN_BATCH:(slot + 1) * RUN_BATCH]), c["i"]


# -- the tools built on run ------------------------------------------------------------


def test_quality_matrix_skips_done_cells(tmp_path, capsys):
    """A cell in the JSONL (name, scene, seed, budget) is not run again; a
    missing one is appended with its scene, budget and device; the summary
    covers both."""
    out = tmp_path / "qm.jsonl"
    done = {"name": "occ13_32p24f", "scene": "smooth", "seed": 0, "budget_s": 5.0,
            "iters": 7, "psnr": 30.0, "ssim": 0.9, "device": "elsewhere"}
    out.write_text(json.dumps(done) + "\n")
    rows = quality_matrix.main(["budget=5", "seeds=0,1", "variants=occ13_32p24f",
                                "scenes=smooth", f"out={out}"], device="cpu", max_iters=2,
                               granule=TINY, batch_size=64)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 2 and lines[0] == done
    new = lines[1]
    assert (new["name"], new["scene"], new["seed"], new["budget_s"]) == (
        "occ13_32p24f", "smooth", 1, 5.0)
    assert new["iters"] == 2 and new["device"] == "cpu"
    assert rows == lines
    text = capsys.readouterr().out
    assert "[occ13_32p24f seed=1]" in text and "[occ13_32p24f seed=0]" not in text
    assert "-- smooth --" in text and "n=2)" in text


def test_quality_real_scale_skips_done_cells(tmp_path, monkeypatch, capsys):
    """The real-schema scene at 8x6 pixels (90 views) from memory: a done
    cell is skipped, the other appended with the ray count."""
    monkeypatch.setattr(quality_real_scale.tempfile, "tempdir", str(tmp_path))
    out = tmp_path / "qrs.jsonl"
    argv = ["budget=5", "seeds=0,1", "height=8", "width=6", "blobs=3", "blob_max=0.9",
            "variants=occ13_32p24f", f"out={out}", "source=memory"]
    tag = "real_scale_8x6_b3_w0.9_n0.002"
    done = {"name": "occ13_32p24f", "seed": 1, "scene": tag, "iters": 9, "psnr": 30.0,
            "ssim": 0.9}
    out.write_text(json.dumps(done) + "\n")
    rows = quality_real_scale.main(argv, device="cpu", max_iters=2, batch_size=256)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 2 and lines[0] == done and rows == lines
    assert (lines[1]["seed"], lines[1]["scene"], lines[1]["iters"]) == (0, tag, 2)
    assert lines[1]["num_rays"] > 0 and lines[1]["device"] == "cpu"
    text = capsys.readouterr().out
    assert "[occ13_32p24f seed=0]" in text and "[occ13_32p24f seed=1]" not in text


@pytest.mark.parametrize("source", real_scale_demo.SOURCES)
def test_real_scale_demo_runs_small(source, capsys):
    """8x6 pixels x 90 views, 2 warm and 3 timed steps, a 3 km grid (the
    20 km default needs a wider swath): the JAX tool's lines and report."""
    keep = {}
    report = real_scale_demo.main(["height=8", "width=6", "steps=3", f"source={source}"],
                                  device="cpu", warm_steps=2, batch_size=256,
                                  extract_step=(3000.0, 2000.0), keep=keep)
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == report
    assert [x[:3] for x in lines if x.startswith("[")] == ["[1]", "[2]", "[3]", "[4]"]
    assert report["source"] == source and report["device"] == "cpu"
    assert report["num_rays"] == keep["dataset"].num_rays > 0
    assert report["steady_rays_per_s"] > 0 and np.isfinite(report["final_loss"])
    assert report["extract_points"] == len(keep["grid"]) > 0
    assert report["device_memory"] == "not measured" and keep["steps"] == 6
    assert (report["extract_file_mb"] is None) == (source == "memory")


def test_real_scale_sources_give_one_dataset(tmp_path):
    kw = {"n_blobs": 4, "blob_max": 0.8, "noise": 0.002}
    cfg = {"type": "HARP2", "max_abs_view_angle": 45.0, "ray_origin_height": 20000,
           "bands_to_keep": [0, 1, 2, 3], "rgb_mode": "nadir"}
    a, ta = real_scale_demo.load_real_scale(cfg, "file", torch.device("cpu"), tmp_path, 9, 7,
                                            **kw)
    b, tb = real_scale_demo.load_real_scale(cfg, "memory", torch.device("cpu"), tmp_path, 9, 7,
                                            **kw)
    assert a.num_rays == b.num_rays
    for k, v in a.host_rays().items():
        assert np.array_equal(v, b.host_rays()[k]), k
    assert ta["granule_s"] is not None and tb["granule_mb"] > ta["granule_mb"]  # float64
    _, again = real_scale_demo.load_real_scale(cfg, "file", torch.device("cpu"), tmp_path, 9, 7,
                                               **kw)
    assert again["granule_s"] is None  # the file was there: not written again
    with pytest.raises(ValueError, match="source"):
        real_scale_demo.load_real_scale(cfg, "s3", torch.device("cpu"), tmp_path, 9, 7)
