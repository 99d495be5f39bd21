"""Multi-granule training in the port (``training/multi.py``) on the CPU:
the device partition against the JAX package's, granules trained together
equal to each one trained alone, the SIGTERM fan-out, a failing granule, and
the train CLI with several scenes in one process.

The trainers are ``tests/test_torch_train.py``'s small q8 Instant-NGP on the
synthetic granule, 256 rays a step (about four steps an epoch)."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from atmonr_tpu.training.multi import partition_devices as jpartition
from atmonr_tpu_torch.scripts import train as train_cli
from atmonr_tpu_torch.training import checkpoint as tckpt
from atmonr_tpu_torch.training.multi import _tagged_print, partition_devices, train_granules
from test_torch_pipeline import SCENE
from test_torch_train import _make_trainer, _small_config, _trainer_config


@pytest.mark.parametrize("n_granules,n_devices", [(2, 8), (3, 8), (3, 2), (1, 8)])
def test_partition_devices_matches_jax(n_granules, n_devices):
    """The same contiguous groups, or with fewer devices than granules the
    same round-robin, as JAX's ``partition_devices`` over its virtual
    devices."""
    devices = jax.devices()[:n_devices]
    want = [[devices.index(d) for d in g] for g in jpartition(n_granules, devices=devices)]
    assert partition_devices(n_granules, range(n_devices)) == want
    assert partition_devices(n_granules, ["cpu"]) == [["cpu"]] * n_granules
    with pytest.raises(ValueError):
        partition_devices(2, [])


def _trainers(tmp_path, n=2, **over):
    over = dict({"batch_size": 256, "num_iters": 6}, **over)
    return [_make_trainer(tmp_path / f"g{g}", seed=g, name=f"g{g}", **over) for g in range(n)]


def _state(tr) -> dict:
    return {k: v.clone() for k, v in tr.pipeline.state_dict().items()}


def test_granules_trained_together_equal_lone_trainers(tmp_path, capsys):
    """Two granules round-robin in one process, each placed on the CPU,
    end bit for bit where a lone Trainer of the same seed ends; each writes
    its own checkpoints; console lines carry the granule's tag."""
    together = _trainers(tmp_path / "together")
    for t in together:
        t.place("cpu")
    outs = [tmp_path / "together" / f"granule_{g}" for g in range(2)]
    train_granules(together, outs)
    text = capsys.readouterr().out
    assert "[granule 0] Epoch" in text and "[granule 1] Epoch" in text
    alone = _trainers(tmp_path / "alone")
    for g, t in enumerate(alone):
        t.train(tmp_path / "alone" / f"out{g}")
    for a, b, out in zip(together, alone, outs):
        assert a.iter_count == b.iter_count == 6
        assert tckpt.latest_epoch(out) == a.epoch_idx
        sa, sb = _state(a), _state(b)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert not torch.equal(together[0].pipeline.pos_table, together[1].pipeline.pos_table)


def test_sigterm_fans_out_to_every_granule(tmp_path, capsys):
    """SIGTERM during granule 0's third step: both granules finish the step
    in flight, write a checkpoint and stop early."""
    handler = signal.getsignal(signal.SIGTERM)
    try:
        trainers = _trainers(tmp_path, num_iters=40)
        step = trainers[0].step

        def step_then_sigterm(*args, **kwargs):
            loss = step(*args, **kwargs)
            if trainers[0].iter_count == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return loss

        trainers[0].step = step_then_sigterm
        outs = [tmp_path / f"granule_{g}" for g in range(2)]
        train_granules(trainers, outs)
    finally:
        signal.signal(signal.SIGTERM, handler)
    for t, out in zip(trainers, outs):
        assert t._preempted and t.iter_count <= 4
        assert tckpt.latest_epoch(out) == t.epoch_idx == 1
    text = capsys.readouterr().out
    assert text.count("preempted: checkpoint epoch 1 saved") == 2


def test_a_failing_granule_closes_the_others(tmp_path):
    """Granule 1 raises in its sixth step: the error reaches the caller,
    granule 0's generator is closed, and its checkpoint writes have landed
    (the epoch it finished is on disk, no temporary file is left)."""
    handler = signal.getsignal(signal.SIGTERM)
    try:
        trainers = _trainers(tmp_path, num_iters=40)
        step = trainers[1].step

        def step_or_fail(*args, **kwargs):
            if trainers[1].iter_count == 5:
                raise RuntimeError("granule 1 fails")
            return step(*args, **kwargs)

        trainers[1].step = step_or_fail
        waited = []
        wait = trainers[0].checkpointer.wait
        trainers[0].checkpointer.wait = lambda: (waited.append(True), wait())[1]
        outs = [tmp_path / f"granule_{g}" for g in range(2)]
        with pytest.raises(RuntimeError, match="granule 1 fails"):
            train_granules(trainers, outs)
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert waited and trainers[0].checkpointer._thread is None
    assert trainers[0].epoch_idx >= 1
    assert tckpt.latest_epoch(outs[0]) == trainers[0].epoch_idx
    assert not list(outs[0].glob("*.tmp"))
    with pytest.raises(ValueError):
        train_granules(trainers, outs[:1])


def test_tagged_print(capsys):
    _tagged_print("granule 3", "12/40 | Loss: 0.5", end="\r")
    _tagged_print("granule 3")
    assert capsys.readouterr().out == "[granule 3] 12/40 | Loss: 0.5\n\n"


def test_train_cli_trains_one_model_per_granule(tmp_path):
    """``--scene-filename a,b`` in one process: granule g trains with seed
    ``--seed + g`` and writes ``granule_<g>/`` with its own ``args.json``,
    ``config.json`` and checkpoints; the top directory has the run's."""
    handler = signal.getsignal(signal.SIGTERM)
    config = dict(_small_config(), trainer=_trainer_config(batch_size=256, num_iters=4))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    other = "synthetic:8x16x2"
    try:
        trainers = train_cli.main([
            "--exp-name", "mg", "--config-path", str(path), "--scene-filename",
            f"{SCENE},{other},", "--data-root", str(tmp_path), "--device", "cpu", "--seed", "5",
        ])
    finally:
        signal.signal(signal.SIGTERM, handler)
    out = tmp_path / "output" / "mg"
    assert json.loads((out / "args.json").read_text())["scene_filename"] == f"{SCENE},{other}"
    assert [t.seed for t in trainers] == [5, 6]
    for g, scene in enumerate((SCENE, other)):
        sub = out / f"granule_{g}"
        assert json.loads((sub / "args.json").read_text())["scene_filename"] == scene
        assert json.loads((sub / "config.json").read_text()) == config
        assert tckpt.latest_epoch(sub) == trainers[g].epoch_idx
        assert trainers[g].iter_count == 4
    assert trainers[0].num_rays != trainers[1].num_rays or not np.array_equal(
        trainers[0].dataset.ray_rad, trainers[1].dataset.ray_rad)
