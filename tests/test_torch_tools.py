"""The port's measurement tools (``atmonr_tpu_torch/tools/``) and its bench,
run on the CPU at tiny sizes: each ``main`` prints its lines and returns
its numbers, and each runs on the card unless the caller names the CPU.
``bench_scaling`` also runs over two gloo ranks (``tests/_torch_ranks.py``).
The numbers themselves are the card's (``chip_smoke.py``'s tools phase);
here only their shape and the control flow are checked.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.optim.optimizer import register_optimizer_step_pre_hook

import _torch_ranks as ranks
from atmonr_tpu_torch import Trainer, bench
from atmonr_tpu_torch.models.hash_grid import HashGridConfig
from atmonr_tpu_torch.tools import (
    ab_clip_cost, ab_importance, ab_q8_sr, ab_q8_train_fp_eval, ab_q8_twophase,
    bench_dma_gather, bench_ref_capacity, bench_scaling, bench_trainer, diag_fwd_breakdown,
    diag_ref_capacity, profile_step, quality_matrix, quality_real_scale, real_scale_demo,
)
from atmonr_tpu_torch.tools import repro_occ15_collapse as collapse
from atmonr_tpu_torch.utils.config import load_config

FLAGSHIP = "configs/instant_ngp_tpu_occ13.json"
TINY = {"height": 8, "width": 6, "views_per_band": 2}
# the JAX tool's report (tools/bench_trainer.py), and the device it ran on
TRAINER_KEYS = {
    "config", "progress", "num_rays", "batch_size", "steps_per_epoch", "epochs_timed",
    "in_epoch_rays_per_s", "overall_rays_per_s", "epoch_sync_s",
    "real_scale_steps_per_epoch", "real_scale_rays_per_s", "device",
}


def _json_lines(out: str) -> list[dict]:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


ENTRY_POINTS = {
    "bench": lambda: bench.main(),
    "bench_dma_gather": lambda: bench_dma_gather.main([]),
    "profile_step": lambda: profile_step.main([]),
    "diag_fwd_breakdown": lambda: diag_fwd_breakdown.main(),
    "bench_trainer": lambda: bench_trainer.main([]),
    "bench_scaling": lambda: bench_scaling.main([]),
    "ab_importance": lambda: ab_importance.main([]),
    "ab_importance.run": lambda: ab_importance.run("x", FLAGSHIP, 1),
    "quality_matrix": lambda: quality_matrix.main([]),
    "ab_q8_sr": lambda: ab_q8_sr.main([]),
    "real_scale_demo": lambda: real_scale_demo.main([]),
    "quality_real_scale": lambda: quality_real_scale.main([]),
    "ab_q8_train_fp_eval": lambda: ab_q8_train_fp_eval.main([]),
    "ab_q8_twophase": lambda: ab_q8_twophase.main([]),
    "bench_ref_capacity": lambda: bench_ref_capacity.main([]),
    "diag_ref_capacity": lambda: diag_ref_capacity.main([]),
    "ab_clip_cost": lambda: ab_clip_cost.main([]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Without ``device`` each runs on ``cuda``, and raises where there is
    none rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_the_table_sizes():
    """The default table is the JAX tool's (2^21 entries of two f32
    features, 32,768 rows of 512 bytes); ``TILE_ROWS_OCC21`` rows hold the
    position table of ``configs/instant_ngp_occ21.json``."""
    assert bench_dma_gather.TILE_ROWS * 512 == (1 << 21) * 2 * 4
    enc = load_config("configs/instant_ngp_occ21.json")["pipeline"]["instant_ngp"]["encoding"]
    rows = HashGridConfig.from_options(enc, 3).total_params
    assert rows == 21_141_696 == bench_dma_gather.TILE_ROWS_OCC21 * 64


def test_the_fetch_bound_holds_only_beyond_the_l2():
    """The 2^21-entry table (16.8 MB) is read from the L2, which has no
    published rate: no bound. The 169 MB table's bound is its bytes in and
    out over 3.35 TB/s: 40.2 us for 64 MiB each way and the indices."""
    n_desc = bench_dma_gather.FETCHED_TILE_ROWS
    ms, by = bench_dma_gather.fetch_bound(bench_dma_gather.TILE_ROWS, n_desc, 1)
    assert ms is None and "L2" in by
    ms, by = bench_dma_gather.fetch_bound(bench_dma_gather.TILE_ROWS_OCC21, n_desc, 1)
    assert by == "bytes" and ms == pytest.approx(1e3 * (2 * (1 << 26) + 4 * n_desc) / 3.35e12)
    assert round(ms * 1e3, 1) == 40.2


def test_bench_dma_gather_prints_its_curves(capsys):
    out = bench_dma_gather.main(["--tile-rows", "64"], device="cpu", n_lookups=256,
                                fetched_tile_rows=8192, warm=1, iters=1, fetch_warm=1,
                                fetch_iters=1)
    text = capsys.readouterr().out
    assert _json_lines(text)[-1] == out
    assert (out["table_rows"], out["n_lookups"], out["tile_row_bytes"]) == (4096, 256, 512)
    names = [r["name"] for r in out["results"]]
    assert names == (
        ["index_select_f32", "index_select_bf16", "index_select_f32_sorted"]
        + [f"index_select_{t}_row{g * 2 * b}B" for g in (2, 8, 32, 64)
           for t, b in (("f32", 4), ("bf16", 2))]
        + [f"block_fetch_{rpd}tile" for rpd in (1, 4, 32)]
    )
    for r in out["results"]:
        assert r["ms"] > 0 and r.get("rows_per_s", r.get("desc_per_s")) > 0
    fetch = out["results"][-3:]
    assert all(r["equal"] and "device_ms" not in r for r in fetch)  # no device time on the CPU
    assert all(r["max_abs_err"] == 0.0 and r["bound_ms"] is None for r in fetch)  # fits the L2
    assert all(line.startswith("[0.0 MB table]") for line in text.splitlines()[:-1])


def test_profile_step_prints_its_stages(capsys):
    times = profile_step.main([FLAGSHIP], device="cpu", batch=64, granule=TINY, iters=1,
                              warmup=1)
    text = capsys.readouterr().out
    assert set(times) == {"encode_fwd", "encode_fwd_bwd", "forward", "grad", "step",
                          "backward", "update"}
    assert all(times[k] > 0 for k in ("encode_fwd", "encode_fwd_bwd", "forward", "grad", "step"))
    assert times["backward"] == times["grad"] - times["forward"]
    for label in ("hash-encode fwd (1536 pts):", "hash-encode fwd+bwd:", "pipeline forward:",
                  "pipeline fwd+bwd (grad):", "full train step:", "rays/s at B=64:"):
        assert label in text


def test_diag_fwd_breakdown_prints_its_pieces(capsys):
    out = diag_fwd_breakdown.main(device="cpu", m=256, iters=1, warm=1)
    text = capsys.readouterr().out
    # no kernel on the CPU, so no "kernel only" piece and no device time
    assert set(out) == {"bf16 prepare_table", "bf16 hash_encode", "q8 prepare_table",
                        "q8 prepare_table noise", "q8 hash_encode"}
    assert all(v["ms"] > 0 and v["device_ms"] is None for v in out.values())
    assert "--- mode=bf16, M=256, T=126976" in text and "position relayout" in text
    assert text.count("prepare_table share of the encode") == 2


def test_bench_trainer_reports(capsys):
    """The JAX tool's report from ``Trainer.iterate``: 1,011 rays in steps
    of 256, one epoch of warm-up and two timed."""
    report = bench_trainer.main(["height=16", "width=8", "epochs=2", f"config={FLAGSHIP}"],
                                device="cpu", warm_epochs=1, batch_size=256)
    assert _json_lines(capsys.readouterr().out)[-1] == report
    assert set(report) == TRAINER_KEYS
    assert (report["batch_size"], report["steps_per_epoch"], report["epochs_timed"]) == (256, 3, 2)
    assert report["real_scale_steps_per_epoch"] == 14_600_000 // 256
    assert report["in_epoch_rays_per_s"] > 0 and report["overall_rays_per_s"] > 0
    with pytest.raises(ValueError, match="3 or more"):
        bench_trainer.main(["height=16", "width=8"], device="cpu", batch_size=512)


def test_bench_scaling_in_one_process(capsys):
    """Without torchrun: a world of one over gloo, the default sweep
    (``data=1,sample=1`` only), the group left as it was found."""
    out = bench_scaling.main([], device="cpu", iters=1, granule=TINY, base_batch=64,
                             max_warm_iters=1, warm_block=1)
    assert list(out) == ["data=1,sample=1"] and out["data=1,sample=1"] > 0
    assert not dist.is_initialized()
    text = capsys.readouterr().out
    assert "devices: 1 x cpu" in text and "[mesh data=1,sample=1] batch=64 1 iters" in text


def test_bench_scaling_over_two_gloo_ranks(tmp_path):
    """Two ranks: ``data=1`` runs on rank 0 alone (rank 1 is outside its
    mesh), ``data=2`` on both, 64 rays per data index."""
    r0, r1 = ranks.spawn(2, tmp_path, ranks.scaling_ranks, TINY)
    assert r0["data=1"] > 0 and r1["data=1"] is None
    assert r0["data=2"] > 0 and r1["data=2"] > 0


def test_ab_importance_main_compares_the_samplers(capsys):
    """The three samplers' configs, one line and one result each."""
    out = ab_importance.main([], device="cpu", num_iters=2, granule=TINY, batch_size=64)
    assert [r["name"] for r in out] == list(ab_importance.VARIANTS)
    assert all(r["iters"] == 2 and r["device"] == "cpu" for r in out)
    text = capsys.readouterr().out
    assert all(f"[{name} seed=0] 2 iters" in text for name in ab_importance.VARIANTS)


def test_ab_q8_sr_sweeps_seeds(capsys):
    """The hard scene (its blobs need a swath of 16 x 12 pixels or more)."""
    table = ab_q8_sr.main(["hard", "seeds=0,1", "iters=2", "q8det"], device="cpu",
                          granule={"height": 16, "width": 12, "views_per_band": 1},
                          batch_size=64)
    assert list(table) == ["q8det"] and len(table["q8det"]) == 2
    assert "== hard scene, 2 iters, seeds [0, 1] ==" in capsys.readouterr().out


def test_two_phase_hands_the_state_over(monkeypatch):
    """Steps before the switch go through the q8 config's Trainer, the rest
    through the flagship's, from the parameters, grid, optimizer state and
    step count the first left; the fp-eval tool switches after the last
    step."""
    calls = []
    real = Trainer.step

    def recording(self, *args, **kwargs):
        pipe = self.pipeline
        calls.append((self.iter_count, pipe.pos_cfg.fwd_mode, pipe.pos_sr, self.optimizer.count))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(Trainer, "step", recording)
    r = ab_q8_twophase.main(["0.5"], device="cpu", num_iters=4, granule=TINY, batch_size=64)
    assert [c[:3] for c in calls] == [(0, "q8", False), (1, "q8", False), (2, "q8", True),
                                      (3, "q8", True)]
    assert [c[3] for c in calls] == [0, 1, 2, 3]  # one optimizer state throughout
    assert r["iters"] == 4 and np.isfinite(r["psnr"]) and r["device"] == "cpu"
    calls.clear()
    r = ab_q8_train_fp_eval.main([], device="cpu", num_iters=3, granule=TINY, batch_size=64)
    assert [c[:3] for c in calls] == [(i, "q8", False) for i in range(3)]
    assert np.isfinite(r["psnr"])


# every entry point of the port that trains, at a tiny size on the CPU
TRAINING_TOOLS = {
    "bench.main": lambda tmp: bench.main(
        device="cpu", batch_size=64, granule=TINY, warmup_block=2, max_warmup_iters=4,
        provisional_iters=2, timed_iters=2),
    "ab_importance.run": lambda tmp: ab_importance.run(
        "x", FLAGSHIP, 3, device="cpu", granule=TINY, batch_size=64),
    "real_scale_demo.main": lambda tmp: real_scale_demo.main(
        ["height=8", "width=6", "steps=2", "source=memory"], device="cpu", warm_steps=1,
        batch_size=256, extract_step=(3000.0, 2000.0)),
    "repro_occ15_collapse.main": lambda tmp: collapse.main(
        ["config=configs/instant_ngp_tpu_occ13_q8sr.json", "iters=3", "seed=0",
         f"out={tmp / 'rows.jsonl'}"], device="cpu",
        granule={"height": 12, "width": 8, "views_per_band": 2}, batch_size=32),
    "profile_step.main": lambda tmp: profile_step.main(
        [FLAGSHIP], device="cpu", batch=64, granule=TINY, iters=1, warmup=1),
    "ab_clip_cost.main": lambda tmp: ab_clip_cost.main(
        ["iters=1"], device="cpu", granule=TINY, batch_size=64, warmup=1),
    "ab_q8_twophase.main": lambda tmp: ab_q8_twophase.main(
        ["0.5"], device="cpu", num_iters=2, granule=TINY, batch_size=64),
}


@pytest.mark.parametrize("tool", sorted(TRAINING_TOOLS))
def test_every_update_of_a_training_tool_is_a_trainer_step(tool, tmp_path, monkeypatch):
    """Every optimizer update the tool makes is made inside ``Trainer.step``,
    one update a call: the tools train with the step that users and the
    benchmark run."""
    inside, steps, updates = [], [], []
    real = Trainer.step

    def recording(self, *args, **kwargs):
        steps.append(self.iter_count)
        inside.append(self)
        try:
            return real(self, *args, **kwargs)
        finally:
            inside.pop()

    monkeypatch.setattr(Trainer, "step", recording)
    hook = register_optimizer_step_pre_hook(lambda *_: updates.append(bool(inside)))
    try:
        TRAINING_TOOLS[tool](tmp_path)
    finally:
        hook.remove()
    assert steps and len(updates) == len(steps)
    assert all(updates)


def test_reference_capacity_tools_run_small(capsys):
    """At the flagship's shapes on a tiny granule: the Trainer's steady
    step, and the five stages (``profile_step``'s where they are its)."""
    r = bench_ref_capacity.main(["iters=1", "warmup=1", f"config={FLAGSHIP}"], device="cpu",
                                granule=TINY)
    assert r["step_ms"] > 0 and r["rays_per_s"] > 0 and np.isfinite(r["loss"])
    times = diag_ref_capacity.main(["batch=32", "iters=1", f"config={FLAGSHIP}"], device="cpu",
                                   granule=TINY)
    assert list(times) == ["encode_fwd", "pipeline_fwd", "encode_bwd", "full_grad",
                           "train_step"]
    assert all(t > 0 for t in times.values())
    assert diag_ref_capacity.main(["batch=32", "iters=1", f"config={FLAGSHIP}", "stage=step"],
                                  device="cpu", granule=TINY).keys() == {"train_step"}
    text = capsys.readouterr().out
    assert "points/iter=0.0M" in text and "steady step:" in text


def test_ab_clip_cost_interleaves_the_arms(capsys):
    out = ab_clip_cost.main(["iters=2"], device="cpu", granule=TINY, batch_size=64, warmup=1)
    assert len(out["clip"]) == len(out["noclip"]) == 3 and np.isfinite(out["cost"])
    lines = [x.split()[0] for x in capsys.readouterr().out.splitlines()[:6]]
    assert lines == ["noclip", "clip"] * 3
