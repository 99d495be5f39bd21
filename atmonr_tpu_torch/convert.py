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
