"""The Trainer's epoch RGB image and asynchronous checkpoints, on the CPU:
the RGB view pick and ``get_rgb`` against the JAX package's, the epoch
image against the JAX ``Trainer``'s for the same three prediction buffers,
the NeRF progress buffers, and ``AsyncCheckpointManager``: a save holds the
state at the save, a writer's error reaches the caller, and a run resumed
from an asynchronous checkpoint continues as one resumed from a synchronous
one. (The surface and atmosphere buffers after Instant-NGP steps are held
to JAX's in ``tests/test_torch_train.py``.)"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmonr_tpu.data import harp2 as jharp2
from atmonr_tpu.pipelines.instant_ngp import InstantNGPPipeline as JaxPipeline
from atmonr_tpu.training.trainer import Trainer as JaxTrainer
from atmonr_tpu_torch import Trainer, get_dataset, get_pipeline
from atmonr_tpu_torch.data import harp2 as tharp2
from atmonr_tpu_torch.data.synthetic import make_synthetic_granule
from atmonr_tpu_torch.training import checkpoint as tckpt
from test_torch_nerf import _nerf_config
from test_torch_pipeline import N_RAYS, SCENE, _config, _jax_dataset
from test_torch_train import _final_state, _make_trainer, _trainer_config

# -- the RGB view pick ------------------------------------------------------------


def _views(case: str):
    """(view_angles, valid_counts, irgb_idx) of 12 views, 3 per band class;
    "striped": the two most nadir red views have a third of the pixels;
    "no-green" / "no-red": that band's views are infrared."""
    rng = np.random.default_rng(4)
    angles = rng.uniform(-50.0, 50.0, 12)
    irgb = np.array([0, 1, 2, 3] * 3)
    counts = rng.integers(900, 1000, 12)
    if case == "striped":
        red = np.flatnonzero(irgb == 1)
        counts[red[np.argsort(np.abs(angles[red]))[:2]]] = 300
    elif case in ("no-green", "no-red"):
        irgb[irgb == (2 if case == "no-green" else 1)] = 0
    return angles, counts, irgb


@pytest.mark.parametrize("mode", ["nadir", "most_pixels"])
@pytest.mark.parametrize("case", ["clean", "striped", "no-green", "no-red"])
def test_select_rgb_views_matches_jax(case, mode):
    angles, counts, irgb = _views(case)
    for penalize in (False, True):
        got = tharp2.select_rgb_views(angles, counts, irgb, penalize_striping=penalize, mode=mode)
        want = jharp2.select_rgb_views(angles, counts, irgb, penalize_striping=penalize, mode=mode)
        assert got == want and all(isinstance(v, int) for v in got)
    if case == "striped":
        # an L1B granule's striped views lose to every clean one
        assert counts[got[0]] > 300
    if case in ("clean", "striped"):  # a band missing picks the best view of all
        with pytest.raises(NotImplementedError, match="rgb_mode"):
            tharp2.select_rgb_views(angles, counts, irgb, penalize_striping=False,
                                    mode="brightest")


@pytest.mark.parametrize("mode", ["nadir", "most_pixels"])
def test_datasets_pick_jax_rgb_views(mode):
    """``best_rgb_idx`` from the config's ``rgb_mode``, the striping penalty
    on for the L1B synthetic granule; ``get_rgb`` of one cube equal."""
    config = _config("xla")
    config["dataset"]["rgb_mode"] = mode
    granule = make_synthetic_granule(height=16, width=8, views_per_band=2)
    tds = tharp2.HARP2Dataset(config["dataset"], granule, device="cpu")
    jds = _jax_dataset(config)
    assert granule.level == "L1B" and tds.best_rgb_idx == jds.best_rgb_idx
    cube = np.random.default_rng(2).uniform(-0.1, 1.2, (tds.view_idx.shape[0], *tds.img_shp))
    cube = (cube * tds.max_i).astype(np.float32)
    got = tds.get_rgb(cube)
    assert got.shape == (*tds.img_shp, 3) and got.min() == 0.0 and got.max() == 1.0
    np.testing.assert_array_equal(got, jds.get_rgb(cube))
    with pytest.raises(ValueError, match="image cube"):
        tds.get_rgb(cube[:, :-1])


# -- the epoch image -----------------------------------------------------------------


class _Images:
    """A logger that keeps what it is given."""

    def __init__(self) -> None:
        self.images: dict[str, tuple[np.ndarray, int]] = {}

    def scalar(self, tag, value, step) -> None:
        pass

    def image(self, tag, img, step) -> None:
        self.images[tag] = (np.asarray(img), step)

    def flush(self) -> None:
        pass


def test_epoch_image_matches_jax(tmp_path):
    """The same three prediction buffers in both Trainers: the epoch's
    image (surface | atmosphere | full | target) is the JAX Trainer's, bit
    for bit, under the same tag and step."""
    config = _config("xla")
    tr = _make_trainer(tmp_path / "t", mode="xla")
    rng = np.random.default_rng(8)
    pix = rng.uniform(0.0, 1.1 * tr.dataset.max_i, (tr.num_rays, 3)).astype(np.float32)
    tr.progress_pixels.copy_(torch.from_numpy(pix))
    jds = _jax_dataset(config)
    jtr = JaxTrainer(_trainer_config(), jds, JaxPipeline(config["pipeline"], jds), "img",
                     tmp_path / "j")
    for k, col in (("pred_pixels", 0), ("pred_pixels_surf", 1), ("pred_pixels_atmo", 2)):
        jtr.state[k] = jnp.asarray(pix[:, col])
    tr.epoch_idx = jtr.epoch_idx = 3
    tr.logger, jtr.logger = _Images(), _Images()
    tr._end_of_epoch()
    jtr._end_of_epoch()
    assert list(tr.logger.images) == ["Epoch 3"]
    got, step = tr.logger.images["Epoch 3"]
    want, jstep = jtr.logger.images["Epoch 3"]
    h, w = tr.dataset.img_shp
    assert got.shape == (h, 4 * w, 3) and step == jstep == 3
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tr.epoch_image(), want)


def test_epoch_image_reaches_tensorboard(tmp_path):
    accumulator = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    tr = _make_trainer(tmp_path, mode="xla")
    if tr.logger.tb is None:
        pytest.skip("TensorBoard's writer does not import here")
    tr.progress_pixels.uniform_(0.0, tr.dataset.max_i)
    tr.epoch_idx = 1
    tr._end_of_epoch()
    tr.logger.close()
    acc = accumulator.EventAccumulator(str(tr.tensorboard_dir))
    acc.Reload()
    assert "Epoch 1" in acc.Tags()["images"]
    (img,) = acc.Images("Epoch 1")
    h, w = tr.dataset.img_shp
    assert (img.height, img.width) == (h, 4 * w)


def test_nerf_has_no_surface_or_atmosphere_part(tmp_path):
    config = _nerf_config()
    config["pipeline"]["mlp_hidden_dim"] = 16
    tds = get_dataset(config["dataset"], SCENE, device="cpu")
    pipe = get_pipeline(config["pipeline"], tds, device="cpu")
    tr = Trainer(_trainer_config(), tds, pipe, "nerf", tmp_path, device="cpu")
    idx = torch.randperm(tr.num_rays, generator=torch.Generator().manual_seed(0))[:N_RAYS]
    for _ in range(2):
        tr.step(idx)
    pix = tr.progress_pixels
    assert pix.shape == (tr.num_rays, 3)
    assert bool((pix[:, 1:] == 0).all())
    assert bool((pix[idx, 0] != 0).any()) and bool((pix[:, 0] == tr.pred_pixels).all())
    seen = torch.zeros(tr.num_rays, dtype=torch.bool)
    seen[idx] = True
    assert bool((pix[~seen] == 0).all())


# -- asynchronous checkpoints ---------------------------------------------------------


def _state_now(tr) -> dict:
    out = _final_state(tr)
    out["count"] = torch.tensor(tr.optimizer.count)
    return out


def _state_in(ckpt_state: dict, tr) -> dict:
    """``_final_state`` of a Trainer that loaded ``ckpt_state``."""
    tr.pipeline.load_state_dict(ckpt_state["pipeline"])
    tr.optimizer.load_state_dict(ckpt_state["optimizer"])
    return _state_now(tr)


def test_async_save_holds_the_state_at_the_save(tmp_path, monkeypatch):
    """The writer is held back until two more steps have updated the
    parameters and moments in place: the checkpoint still holds the state
    at the save, bit for bit."""
    tr = _make_trainer(tmp_path, mode="xla")
    idx = torch.arange(N_RAYS)
    tr.step(idx)
    gate, real = threading.Event(), tckpt.save_checkpoint

    def held(*args):
        assert gate.wait(60)
        return real(*args)

    monkeypatch.setattr(tckpt, "save_checkpoint", held)
    at_save = {k: v.clone() for k, v in _state_now(tr).items()}
    tr.save(tmp_path / "out", 1)
    for _ in range(2):
        tr.step(idx)
    after = _state_now(tr)
    assert not torch.equal(after["pos_table"], at_save["pos_table"])
    gate.set()
    tr.checkpointer.wait()
    state, epoch = tckpt.restore_checkpoint(tmp_path / "out")
    assert epoch == 1 and state["iter_count"] == 1
    got = _state_in(state, _make_trainer(tmp_path / "x", mode="xla"))
    assert got.keys() == at_save.keys()
    for k in at_save:
        assert torch.equal(got[k], at_save[k]), k
    assert not list((tmp_path / "out").glob("*.tmp"))


def test_a_writer_error_reaches_the_caller(tmp_path, monkeypatch):
    """Raised once, by the next ``wait``, ``save`` or ``close``."""

    def fail(*args):
        raise OSError("no space left on device")

    mgr = tckpt.AsyncCheckpointManager()
    monkeypatch.setattr(tckpt, "save_checkpoint", fail)
    for surface in ("wait", "save", "close"):
        mgr.save(tmp_path, 1, {"w": torch.ones(2)})
        with pytest.raises(OSError, match="no space"):
            if surface == "save":
                mgr.save(tmp_path, 2, {"w": torch.ones(2)})
            else:
                getattr(mgr, surface)()
        mgr.wait()  # already raised: nothing more
    assert not list(tmp_path.iterdir())


def test_resume_from_an_async_checkpoint_equals_a_sync_one(tmp_path):
    """One epoch through ``iterate`` (its save asynchronous), the same state
    saved synchronously beside it: Trainers resumed from either take the
    same next steps, bit for bit on the CPU."""
    kw = dict(batch_size=250, num_iters=8, print_frequency=3)
    first = _make_trainer(tmp_path / "a", name="first", **kw)
    for it in first.iterate(tmp_path / "async"):
        if it == 4:
            first._preempted = True
    assert first.checkpointer._thread is None  # iterate waited for its save
    tckpt.save_checkpoint(tmp_path / "sync", 1, first.checkpoint_state())
    finals = []
    for out in ("async", "sync"):
        tr = _make_trainer(tmp_path / "a", seed=9, name="first", **kw)
        tr.load(tmp_path / out)
        assert tr.iter_count == 4
        tr.train(tmp_path / f"{out}_rest")
        assert tr.iter_count == 8
        finals.append(_state_now(tr))
    a, b = finals
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
