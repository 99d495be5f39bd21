"""The port's user journey through its CLIs on the CPU (``--device cpu``):
``train`` a few steps on a tiny synthetic granule, ``extract`` on the
``l1c`` and ``globalgrid`` grids, then ``make_video --renderer internal``;
and the ``vdb`` route of ``make_video`` with OpenVDB, ``vdb_render`` and
ffmpeg replaced by recording stand-ins, held to the JAX package's
``scripts/make_video.py``."""

import json
import signal
import sys
import types
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from atmonr_tpu_torch import get_dataset, get_extract_dataset, get_pipeline, run_extraction
from atmonr_tpu_torch.extract.orbit_render import render_orbit
from atmonr_tpu_torch.scripts import extract as extract_cli
from atmonr_tpu_torch.scripts import make_video
from atmonr_tpu_torch.scripts import train as train_cli
from atmonr_tpu_torch.training.checkpoint import restore_params
from test_torch_pipeline import SCENE
from test_torch_train import _cli_args

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_make_video():
    """The JAX package's ``scripts/make_video.py`` as a module."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import make_video as module
    finally:
        sys.path.pop(0)
    return module


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4-step training run of the train CLI: its data root."""
    root = tmp_path_factory.mktemp("journey")
    handler = signal.getsignal(signal.SIGTERM)
    try:
        train_cli.main(_cli_args(root, "--num-iters", "4"))
    finally:
        signal.signal(signal.SIGTERM, handler)
    return root


def _extract(root, mode, filename, *extra):
    return extract_cli.main([
        "--exp-name", "cli", "--coord-mode", mode, "--extract-filename", filename,
        "--data-root", str(root), "--device", "cpu", *extra,
    ])


def test_train_extract_video_journey(trained, monkeypatch, capsys):
    out = trained / "output" / "cli"
    monkeypatch.chdir(trained)

    # l1c: the netCDF holds what the restored pipeline answers (at the same
    # batch size: bf16 MLP products may round differently in another)
    grid, sigma, build_s, query_s, path = _extract(
        trained, "l1c", "l1c.nc", "--alt-step", "2000", "--batch-size", "500")
    assert path == out / "l1c.nc" and build_s > 0 and query_s > 0
    text = capsys.readouterr().out
    assert "l1c grid: 1408 points" in text and "extract batch 3/3" in text
    config = json.loads((out / "config.json").read_text())
    ds = get_dataset(config["dataset"], SCENE, device="cpu")
    pipe = get_pipeline(config["pipeline"], ds, device="cpu")
    points = get_extract_dataset("l1c", ds, alt_step=2000.0)
    fresh = run_extraction(pipe, points, batch_size=500)
    assert restore_params(out, pipe) >= 1
    want = run_extraction(pipe, points, batch_size=500)
    assert not np.array_equal(want, fresh), "the checkpoint must move the field"
    np.testing.assert_array_equal(sigma, want)
    with h5py.File(out / "l1c.nc", "r") as f:
        nc = f["extinction_coefficient"][()]
        assert nc.shape == grid.shp + (1,) and f.attrs["input_l1b_product_name"] == \
            ds.granule.product_name
    np.testing.assert_array_equal(nc.reshape(-1, 1), want)

    # globalgrid: the .npy pair where OpenVDB is missing
    with pytest.warns(UserWarning, match="OpenVDB"):
        gg, gsigma = _extract(trained, "globalgrid", "gg.vdb", "--grid-res", "0.05")[:2]
    vox, vsig = np.load(out / "gg_voxels.npy"), np.load(out / "gg_sigma.npy")
    assert vox.shape == (len(gg), 3) and vsig.shape == (len(gg), 1)
    np.testing.assert_array_equal(vsig, gsigma)
    assert np.all(np.isfinite(vsig)) and np.all(vsig >= 0)

    # make_video, the port's own renderer: 2 frames (ffmpeg, where present,
    # turns them into the video and removes them)
    video = trained / "j.mp4"
    make_video.main([
        "--extract-filepath", str(out / "l1c.nc"), "--vdb-filepath", str(trained / "j.vdb"),
        "--video-filepath", str(video), "--renderer", "internal", "--res", "64x48",
        "--duration", "0.1", "--frame-rate", "20", "--device", "cpu", "--render-band-idx", "0",
    ])
    frames = sorted((trained / "_temp_frames").glob("*.ppm"))
    assert video.exists() or [p.name for p in frames] == ["000000.ppm", "000001.ppm"]
    if frames:
        vol = make_video.volume_for_render(nc, 0) * ds.scale / 1000
        first = next(render_orbit(vol, 2, width=64, height=48, device="cpu"))
        raw = frames[0].read_bytes()
        assert raw == b"P5\n64 48\n255\n" + first.tobytes()


def test_extract_and_video_default_to_cuda(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_cli.main(["--exp-name", "cli", "--coord-mode", "l1c", "--extract-filename",
                          "x.nc", "--data-root", str(trained), "--alt-step", "4000"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(render_orbit(np.ones((4, 4, 4), np.float32), 1, width=8, height=6))


def _extract_file(path: Path, fill_at=(1, 2, 3)) -> np.ndarray:
    """A small extract netCDF: (along, across, vertical, 2 bands) sigma
    with one fill value."""
    sigma = np.random.default_rng(0).uniform(0, 1e-4, (6, 5, 4, 2)).astype(np.float32)
    sigma[fill_at] = -32767.0
    with h5py.File(path, "w") as f:
        f.attrs["neural_rendering_scene_scale"] = 1234.5
        v = f.create_dataset("extinction_coefficient", data=sigma)
        v.attrs["_FillValue"] = np.float32(-32767.0)
    return sigma


@pytest.mark.parametrize("band", [1, 2], ids=["band1", "missing-band"])
def test_read_extract_sigma_matches_jax(tmp_path, jax_make_video, band):
    """The volume the renderers take (fill values as NaN; a band the file
    does not have falls back to 0 with a warning)."""
    _extract_file(tmp_path / "e.nc")

    def read(module):
        if band < 2:
            return module.read_extract_sigma(str(tmp_path / "e.nc"), band)
        with pytest.warns(UserWarning, match="rendering band 0"):
            return module.read_extract_sigma(str(tmp_path / "e.nc"), band)

    got, want = read(make_video), read(jax_make_video)
    assert got[1] == want[1] == 1234.5
    assert got[0].shape == (5, 4, 6) and got[0].flags.c_contiguous
    assert np.isnan(got[0]).sum() == 1
    np.testing.assert_array_equal(got[0], want[0])


def _fake_vdb(monkeypatch, calls):
    class FakeGrid:
        def copyFromArray(self, arr):
            calls.append(("grid", arr.shape, float(np.nansum(arr))))

    fake = types.SimpleNamespace(
        FloatGrid=FakeGrid, write=lambda path, grids: calls.append(("write", path)))
    monkeypatch.setitem(sys.modules, "pyopenvdb", fake)


def test_make_video_vdb_route_matches_jax(tmp_path, monkeypatch, jax_make_video):
    """``main`` with the ``vdb`` renderer: one vdb_render command a frame,
    then ffmpeg, exactly as the JAX package's script issues them."""
    _extract_file(tmp_path / "e.nc")
    monkeypatch.chdir(tmp_path)
    argv = ["--extract-filepath", "e.nc", "--vdb-filepath", "t.vdb", "--video-filepath",
            "t.mp4", "--res", "64x48", "--duration", "0.3", "--frame-rate", "10"]
    runs = {}
    for name, module, main in (
        ("port", make_video, lambda: make_video.main(argv)),
        ("jax", jax_make_video, None),
    ):
        calls = []
        _fake_vdb(monkeypatch, calls)
        monkeypatch.setattr(module.subprocess, "run", lambda cmd, **kw: calls.append(cmd))
        monkeypatch.setattr(module.shutil, "which", lambda name: f"/usr/bin/{name}")
        if main is None:
            monkeypatch.setattr(sys, "argv", ["make_video.py", *argv])
            module.main()
        else:
            main()
        runs[name] = calls
    assert runs["port"] == runs["jax"]
    cmds = [c for c in runs["port"] if isinstance(c, list)]
    assert [c[0] for c in cmds] == ["vdb_render"] * 3 + ["ffmpeg"]
    assert cmds[1][2] == "_temp_frames/000001.ppm" and cmds[0][cmds[0].index("-res") + 1] == "64x48"
    assert not (tmp_path / "_temp_frames").exists()
