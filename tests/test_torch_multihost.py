"""The port's train and extract CLIs over two processes, launched as on a
machine with two devices (``python -m torch.distributed.run --standalone
--nproc-per-node 2``), on the CPU with gloo: ``--mesh data=2 --distributed``
training leaves the same parameters on both ranks and one log, and
``extract --mesh data=2`` on its checkpoint gives the single-process
extraction's sigma.

The ranks run ``tests/_torch_ranks.py``, which calls each CLI's ``main`` and
saves what its rank holds."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from atmonr_tpu_torch.scripts import extract as extract_cli
from test_torch_pipeline import SCENE
from test_torch_train import _small_config, _trainer_config

REPO = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "_torch_ranks.py"
QUERY = 200  # the mesh query's batch: 100 rows a rank, the single query's batch


def _torchrun(mode: str, dump: Path, *args: str) -> list:
    dump.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", str(RANKS), mode, str(dump), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [torch.load(dump / f"rank{r}.pt", weights_only=True) for r in range(2)]


def test_two_rank_train_then_extract(tmp_path):
    """Six steps at 256 rays over two data ranks: both ranks end with the
    same parameters and occupancy grid, bit for bit; one ``metrics.jsonl``
    is written; the first rank writes the checkpoints. Then ``extract
    --mesh data=2`` at ``--batch-size 200`` queries 100 rows a rank, which
    the single-process extraction at ``--batch-size 100`` queries as whole
    batches: every full batch's sigma is equal bit for bit, and the tail
    (split 50-50 under the mesh, whole alone) to rtol 1e-2 of bfloat16 MLP
    products, which change with the rows in a product on the CPU (ROADMAP
    queue 3)."""
    config = dict(_small_config(), trainer=_trainer_config(batch_size=256, num_iters=6))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    root = tmp_path / "data"
    a, b = _torchrun("train", tmp_path / "train", "--exp-name", "mh", "--config-path", str(path),
                     "--scene-filename", SCENE, "--data-root", str(root), "--device", "cpu",
                     "--mesh", "data=2", "--distributed")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    logs = [p for p in (root / "tensorboard").glob("*/metrics.jsonl") if p.stat().st_size]
    assert len(logs) == 1
    out = root / "output" / "mh"
    assert sorted(p.name for p in out.glob("epoch_*.pt")) == ["epoch_0001.pt", "epoch_0002.pt"]
    assert json.loads((out / "args.json").read_text())["mesh"] == "data=2"

    base = ["--exp-name", "mh", "--coord-mode", "l1c", "--alt-step", "2000", "--data-root",
            str(root), "--device", "cpu"]
    s0, s1 = _torchrun("extract", tmp_path / "extract", *base, "--extract-filename",
                       "mesh.nc", "--mesh", "data=2", "--batch-size", str(QUERY))
    alone = extract_cli.main(base + ["--extract-filename", "one.nc", "--batch-size",
                                     str(QUERY // 2)]).sigma
    assert torch.equal(s0, s1) and s0.shape == alone.shape
    n = len(alone)
    full = n - n % QUERY
    assert full > 0 and np.all(np.isfinite(alone))
    np.testing.assert_array_equal(s0.numpy()[:full], alone[:full])
    np.testing.assert_allclose(s0.numpy()[full:], alone[full:], rtol=1e-2,
                               atol=1e-2 * np.abs(alone).max())


def test_two_ranks_train_two_granules(tmp_path):
    """Two scenes over two ranks: each rank's group of one trains one
    granule (mesh of one rank, seed ``--seed + g``) and, as that mesh's
    first rank, writes ``granule_<g>/`` and its own log."""
    config = dict(_small_config(), trainer=_trainer_config(batch_size=256, num_iters=4))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    root = tmp_path / "data"
    other = "synthetic:8x16x2"
    a, b = _torchrun("train", tmp_path / "train", "--exp-name", "mg", "--config-path",
                     str(path), "--scene-filename", f"{SCENE},{other}", "--data-root", str(root),
                     "--device", "cpu", "--distributed")
    assert not torch.equal(a["pos_table"], b["pos_table"])
    out = root / "output" / "mg"
    for g, scene in enumerate((SCENE, other)):
        assert json.loads((out / f"granule_{g}" / "args.json").read_text())["scene_filename"] \
            == scene
        assert sorted(p.name for p in (out / f"granule_{g}").glob("epoch_*.pt"))
    logs = [p for p in (root / "tensorboard").glob("*/metrics.jsonl") if p.stat().st_size]
    assert sorted(p.parent.name.split("_2")[0] for p in logs) == ["mg_granule0", "mg_granule1"]
