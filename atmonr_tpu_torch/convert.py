"""Parameters between the JAX package's pytree and this package's state dict.

The JAX Instant-NGP parameters are a nested dict: ``pos_table``;
``pos_mlp``, ``dir_mlp`` and ``surf_mlp`` as ``{"layers": [{"w": (out,
in)}, ...]}``; ``surf_enc`` as a list with one dict per surface-encoding
spec, ``{"hash_table": ...}`` for a HashGrid spec and ``{}`` otherwise.
Here they are named ``pos_table``, ``<mlp>.layers.<i>.weight`` (the same
(out, in) matrix) and ``surf_enc.<spec index>``. The JAX NeRF parameters
are ``{"coarse" | "fine": {"fc<i>": {"w": (out, in), "b": (out,)}}}``;
here ``coarse.fc<i>.weight`` and ``coarse.fc<i>.bias``. Both functions tell
the two layouts apart by their keys.

Gradients and AdamW moments have the parameters' structure on both sides:
``params_from_jax`` also takes a ``jax.grad`` result or an optax ``mu`` /
``nu`` tree, and ``grads_state`` / ``moments_state`` name this package's
under the same keys, so the two can be laid side by side.

``jax_ngp_init`` draws the JAX package's Instant-NGP init of a seed without
JAX (``utils/threefry.py``), in the JAX layout, bit for bit: ``load_params(
params_from_jax(jax_ngp_init(config, seed)))`` gives this package the
parameters that ``init_params(jax.random.PRNGKey(seed))`` gives the JAX one.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_MLPS = ("pos_mlp", "dir_mlp", "surf_mlp")
_NERF_MODELS = ("coarse", "fine")
_NERF_LEAVES = (("w", "weight"), ("b", "bias"))


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX nested parameters (numpy or JAX arrays) -> state dict of CPU
    float32 tensors."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    if "coarse" in tree:
        return {
            f"{model}.{layer}.{name}": t(leaves[key])
            for model in _NERF_MODELS
            for layer, leaves in tree[model].items()
            for key, name in _NERF_LEAVES
        }
    out = {"pos_table": t(tree["pos_table"])}
    for name in _MLPS:
        for i, layer in enumerate(tree[name]["layers"]):
            out[f"{name}.layers.{i}.weight"] = t(layer["w"])
    for i, spec in enumerate(tree["surf_enc"]):
        if "hash_table" in spec:
            out[f"surf_enc.{i}"] = t(spec["hash_table"])
    return out


def params_to_jax(
    state: Mapping[str, torch.Tensor], n_surf_specs: int = 0
) -> dict[str, Any]:
    """State dict -> the JAX nested parameters as numpy arrays.
    ``n_surf_specs`` is the number of nested surface-encoding specs of an
    Instant-NGP state (the length of the ``surf_enc`` list, parameter-free
    specs included)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    if any(k.startswith("coarse.") for k in state):
        tree: dict[str, Any] = {model: {} for model in _NERF_MODELS}
        for k, v in state.items():
            model, layer, name = k.split(".")
            key = next(j for j, n in _NERF_LEAVES if n == name)
            tree[model].setdefault(layer, {})[key] = a(v)
        return tree
    tree = {"pos_table": a(state["pos_table"])}
    for name in _MLPS:
        n_layers = sum(
            1 for k in state if k.startswith(f"{name}.layers.") and k.endswith(".weight")
        )
        tree[name] = {
            "layers": [{"w": a(state[f"{name}.layers.{i}.weight"])} for i in range(n_layers)]
        }
    tree["surf_enc"] = [
        {"hash_table": a(state[f"surf_enc.{i}"])} if f"surf_enc.{i}" in state else {}
        for i in range(n_surf_specs)
    ]
    return tree


def grads_state(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The ``.grad`` of every parameter of ``module``, under the
    parameter's name (zeros where a parameter has no gradient yet)."""
    return {
        name: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
        for name, p in module.named_parameters()
    }


def moments_state(
    module: torch.nn.Module, adamw: torch.optim.Optimizer
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """AdamW's first and second moments (``exp_avg``, ``exp_avg_sq``: optax's
    ``mu`` and ``nu``) under the parameters' names; zeros before the first
    update."""
    mu, nu = {}, {}
    for name, p in module.named_parameters():
        state = adamw.state.get(p, {})
        mu[name] = state["exp_avg"].detach().clone() if state else torch.zeros_like(p)
        nu[name] = state["exp_avg_sq"].detach().clone() if state else torch.zeros_like(p)
    return mu, nu


def jax_ngp_init(pipeline_config: Mapping[str, Any], seed: int) -> dict[str, Any]:
    """The JAX package's ``InstantNGPPipeline.init_params(PRNGKey(seed))``
    as numpy arrays in its nested layout: ``split(key, 6)``; the position
    table U(-1e-4, 1e-4) from key 0; the Xavier-uniform density, color and
    surface MLPs from keys 1, 2 and 4 (one ``split`` per MLP, a key per
    layer); the surface encoding's tables from key 3 (a ``split`` per
    HashGrid spec, the table from the second half); a ``"quiet"`` surface
    head scaled by 0.01."""
    from atmonr_tpu_torch.models import hash_grid as hg
    from atmonr_tpu_torch.models.encoders import (
        composite_output_dim,
        hash_grid_configs,
        parse_encoding_config,
    )
    from atmonr_tpu_torch.pipelines.instant_ngp import _POS_MLP_OUT
    from atmonr_tpu_torch.utils import threefry

    ngp = pipeline_config["instant_ngp"]
    num_inputs = 4 if pipeline_config["include_height"] else 3
    num_density = pipeline_config["num_bands"] if pipeline_config["multi_band_extinction"] else 1

    def table(key, cfg: hg.HashGridConfig) -> np.ndarray:
        return threefry.uniform(key, (cfg.total_params, cfg.n_features_per_level), -1e-4, 1e-4)

    def mlp(key, in_dim: int, out_dim: int, net: Mapping[str, Any]) -> dict:
        n, hidden = int(net["n_neurons"]), int(net["n_hidden_layers"])
        dims = [(n, in_dim)] + [(n, n)] * hidden + [(out_dim, n)]
        layers = []
        for k, (o, i) in zip(threefry.split(key, len(dims)), dims):
            bound = (6.0 / (i + o)) ** 0.5
            layers.append({"w": threefry.uniform(k, (o, i), -bound, bound)})
        return {"layers": layers}

    keys = threefry.split(threefry.prng_key(seed), 6)
    pos_cfg = hg.HashGridConfig.from_options(ngp["encoding"], num_inputs)
    dir_specs = parse_encoding_config(ngp["dir_encoding"])
    surf_specs = parse_encoding_config(ngp["surface_encoding"])
    surf_in = 2 + 3
    surf_cfgs = hash_grid_configs(surf_specs, surf_in)
    surf_enc, key = [], keys[3]
    for i in range(len(surf_specs)):
        if i in surf_cfgs:
            key, sub = threefry.split(key, 2)
            surf_enc.append({"hash_table": table(sub, surf_cfgs[i])})
        else:
            surf_enc.append({})
    params = {
        "pos_table": table(keys[0], pos_cfg),
        "pos_mlp": mlp(keys[1], pos_cfg.n_output_dims, _POS_MLP_OUT, ngp["network"]),
        "dir_mlp": mlp(
            keys[2], composite_output_dim(dir_specs, 3 + _POS_MLP_OUT - num_density),
            pipeline_config["num_bands"], ngp["rgb_network"],
        ),
        "surf_enc": surf_enc,
        "surf_mlp": mlp(
            keys[4], composite_output_dim(surf_specs, surf_in), pipeline_config["num_bands"],
            ngp["surface_network"],
        ),
    }
    if pipeline_config.get("surface_head_init", "default") == "quiet":
        last = params["surf_mlp"]["layers"][-1]
        last["w"] = last["w"] * np.float32(0.01)
    return params
