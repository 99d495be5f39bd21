"""The port's hierarchical NeRF against the benchmark's plain float32
reference (``perfbench/reference/nerf.py``), on the CPU at a small size:
``configs/nerf.json`` at 8 + 16 samples and 32-wide MLPs (``L_x`` [14, 14,
10] and ``L_d`` 4 as published), 48 rays of a 16 x 12-pixel real-schema
granule, the benchmark's seeded parameters and draws
(``perfbench/inputs_nerf.py``).

Compared: the coarse and fine color maps, the fine depths, the loss, every
leaf's gradient, and the parameters after three ``Trainer`` steps against
the reference's Adam. The reference is given the program's rays and scene
box and computes the rest itself (sampling, preprocessor, encodings, both
MLPs, compositing, loss, gradients, Adam). On the CPU its own ray build
and the port's host library can round an origin differently in the last
float32 bit, which moves the box by an eighth of a metre; across this
granule's 30 km, an eighth of a metre is a visible angle of the 2^13 pi
encodings.

On the same inputs both sides compute the same float32 operations in the
same order, so the forward agrees to the last bit here. The tolerances
leave room for what may legitimately differ: the GEMM library's summation
order (``x @ W.T + b`` against ``nn.Linear``'s fused bias), the backward's
accumulation order, and Adam's elementwise arithmetic. A reference that
computes its products in bfloat16 fails them."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from atmonr_tpu_torch import Trainer, get_pipeline
from atmonr_tpu_torch.data.harp2 import HARP2Dataset
from perfbench import inputs, inputs_nerf
from perfbench.reference import nerf, scene
from perfbench.runners.train import _granule_arrays

REPO = Path(__file__).resolve().parent.parent
SEED = 2**33 + 29
B = 48
STEPS = 3
# the forward's color maps and depths: rtol 1e-5 of each value plus 1e-6 of
# the largest; a GEMM that sums its products in another order moves a
# float32 result by ~1e-7 a layer, 11 layers deep
FWD = {"rtol": 1e-5, "atol_of_max": 1e-6}
# the gradients: the backward sums 48 rays' products in another order, and
# the fine loss reaches the coarse MLP through the inverse CDF, which
# divides by a bin's probability: 1e-4 of each value plus 1e-5 of the leaf's
# largest
GRAD = {"rtol": 1e-4, "atol_of_max": 1e-5}


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol_of_max: float) -> bool:
    atol = atol_of_max * float(want.abs().max())
    return bool(torch.all((got - want).abs() <= atol + rtol * want.abs()))


@pytest.fixture(scope="module")
def setup():
    config = json.loads((REPO / "perfbench/configs/nerf_hier.json").read_text())
    config["pipeline"].update(sampler={"N_c": 8, "N_f": 16}, mlp_hidden_dim=32)
    config["trainer"]["batch_size"] = B
    granule = inputs.real_schema_granule(16, 12, SEED)
    ds = HARP2Dataset(config["dataset"], _granule_arrays(granule), device="cpu")
    rays, st = ds.rays(), ds.scene_transform
    sc = dataclasses.replace(
        scene.build_scene(granule, config["dataset"], torch.device("cpu")),
        rays={"origin": rays["origin"], "dir": rays["dir"], "len": rays["len"],
              "rad": rays["rad"], "band": rays["irgb_idx"]},
        scale=ds.scale, offset=np.asarray(ds.offset),
        box=(st.lat_min, st.lat_range, st.lon_min, st.lon_range))
    feed = inputs_nerf.Draws(config["pipeline"], len(ds), B, SEED, torch.device("cpu"))
    return {"config": config, "ds": ds, "sc": sc,
            "params": inputs_nerf.make_params(config["pipeline"], SEED, torch.device("cpu")),
            "checked": [(feed.rows(), feed.draws()) for _ in range(STEPS)]}


def _pipe(setup):
    """The port's pipeline with the benchmark's parameters."""
    pipe = get_pipeline(setup["config"]["pipeline"], setup["ds"], device="cpu")
    pipe.load_params(setup["params"])
    return pipe


def _batch(sc, rows):
    return {k: v[rows] for k, v in sc.rays.items()}


def test_the_parameters_are_the_published_shapes(setup):
    pipe = _pipe(setup)
    own = dict(pipe.named_parameters())
    shapes = nerf.param_shapes(setup["config"]["pipeline"])
    assert list(shapes) == list(own)
    assert all(tuple(own[k].shape) == v for k, v in shapes.items())
    # at the published widths: 76 + 24 encoding channels, 256 wide
    full = nerf.param_shapes(json.loads((REPO / "configs/nerf.json").read_text())["pipeline"])
    assert full["coarse.fc1.weight"] == (256, 76) and full["coarse.fc6.weight"] == (256, 332)
    assert full["fine.fc9.weight"] == (260, 256) and full["fine.fc10.weight"] == (128, 280)
    assert sum(int(np.prod(v)) for v in full.values()) == 1_205_261


def test_the_forward_matches_the_reference(setup):
    """The coarse and fine color maps and the fine depths, each side at its
    own fine depths, on the benchmark's draws."""
    pipe, sc = _pipe(setup), setup["sc"]
    rows, draws = setup["checked"][0]
    with torch.no_grad():
        out = pipe(_batch(sc, rows) | {"irgb_idx": sc.rays["band"][rows]}, draws=draws)
        ref = nerf.Model(setup["config"]["pipeline"], sc).render(setup["params"],
                                                                 _batch(sc, rows), draws)
    for got, want in ((out["color_map_coarse"], ref["coarse"]),
                      (out["color_map_fine"], ref["fine"]), (out["z_vals_fine"], ref["z_fine"])):
        assert got.shape == want.shape
        assert _close(got, want, **FWD), float((got - want).abs().max())


def test_the_loss_and_every_gradient_match_the_reference(setup):
    pipe, sc, params = _pipe(setup), setup["sc"], setup["params"]
    rows, draws = setup["checked"][0]
    batch = _batch(sc, rows) | {"irgb_idx": sc.rays["band"][rows]}
    out = pipe(batch, draws=draws)
    loss = pipe.compute_loss(batch, out)
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ref_loss, grads, _ = nerf.Model(setup["config"]["pipeline"], sc).loss_and_grads(
        p, _batch(sc, rows), draws, out["z_vals_fine"].detach())
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-6)
    own = dict(pipe.named_parameters())
    assert set(grads) == set(own)
    for k, g in grads.items():
        assert _close(own[k].grad, g, **GRAD), (k, float((own[k].grad - g).abs().max()))


def _reference_steps(setup, gemm=None, given=None):
    """The reference's losses and parameters after ``STEPS`` Adam steps."""
    sc, config = setup["sc"], setup["config"]
    model = nerf.Model(config["pipeline"], sc, gemm=gemm)
    p = {k: v.clone().requires_grad_(True) for k, v in setup["params"].items()}
    opt = nerf.Adam(p, nerf.lr_schedule(config["trainer"], sc.rays["origin"].shape[0]))
    losses = []
    for s, (rows, draws) in enumerate(setup["checked"]):
        loss, grads, _ = model.loss_and_grads(p, _batch(sc, rows), draws,
                                              None if given is None else given[s])
        opt.step(grads)
        losses.append(float(loss))
    return losses, {k: v.detach() for k, v in p.items()}


@pytest.fixture(scope="module")
def trained(setup, tmp_path_factory):
    """``STEPS`` Trainer steps on the checked rows and draws, the fine
    depths each step's forward returned, and the reference at them."""
    pipe = _pipe(setup)
    trainer = Trainer(setup["config"]["trainer"], setup["ds"], pipe, "ref",
                      tmp_path_factory.mktemp("nerf_ref"), device="cpu")
    pipe.load_params(setup["params"])  # the Trainer drew its own
    depths = []
    hook = pipe.register_forward_hook(lambda m, a, out: depths.append(out["z_vals_fine"].detach()))
    try:
        losses = [float(trainer.step(rows, draws)) for rows, draws in setup["checked"]]
    finally:
        hook.remove()
    own = {k: v.detach().clone() for k, v in pipe.named_parameters()}
    return losses, own, depths, _reference_steps(setup, given=depths)


def _change_gap(own: dict, ref: dict, start: dict) -> float:
    """The worst leaf's gap in the change over the steps, over the norm of
    the reference's change."""
    return max(float(torch.linalg.vector_norm(own[k] - ref[k])
                     / torch.linalg.vector_norm(ref[k] - start[k])) for k in ref)


# Adam's first steps move a weight by about lr whatever the size of its
# gradient, so a weight whose gradient lies within rounding of zero steps
# either way: on this batch 19 of 28,813 parameters do, by up to 3.7e-5 of
# the three steps' 1.5e-3, 1.7e-3 of their leaf's change. 1e-2 leaves over
# five times room; the bfloat16 reference reads 0.8
CHANGE = 1e-2


def test_three_trainer_steps_match_the_reference_adam(setup, trained):
    """Losses to rtol 1e-5; each leaf's change over the three steps to
    ``CHANGE`` of its norm, every leaf moved."""
    losses, own, _, (ref_losses, ref) = trained
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert _change_gap(own, ref, setup["params"]) <= CHANGE
    assert all(not torch.equal(own[k], setup["params"][k]) for k in ref)


def test_a_bfloat16_reference_fails_the_tolerances(setup, trained):
    """The reference with its products in bfloat16 against the float32
    program: the color maps, the loss or the parameters fall outside the
    tolerances above: each of them."""
    losses, own, depths, _ = trained
    bf_losses, bf = _reference_steps(setup, gemm="bf16", given=depths)
    rows, draws = setup["checked"][0]
    with torch.no_grad():
        f32 = nerf.Model(setup["config"]["pipeline"], setup["sc"]).render(
            setup["params"], _batch(setup["sc"], rows), draws)
        b16 = nerf.Model(setup["config"]["pipeline"], setup["sc"], gemm="bf16").render(
            setup["params"], _batch(setup["sc"], rows), draws)
    assert not _close(b16["coarse"], f32["coarse"], **FWD)
    assert not np.allclose(losses, bf_losses, rtol=1e-5, atol=0)
    assert _change_gap(own, bf, setup["params"]) > CHANGE


def test_the_reference_turns_tf32_off_and_restores_it():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    for outer in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = outer
        try:
            with nerf.float32_matmul():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
            with nerf.float32_matmul(allow_tf32=True):
                assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32 == outer
            assert torch.backends.cudnn.allow_tf32 == outer
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
