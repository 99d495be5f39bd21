"""Parameters between the JAX package's pytree and this package's state dict.

The JAX Instant-NGP parameters are a nested dict: ``pos_table``;
``pos_mlp``, ``dir_mlp`` and ``surf_mlp`` as ``{"layers": [{"w": (out,
in)}, ...]}``; ``surf_enc`` as a list with one dict per surface-encoding
spec, ``{"hash_table": ...}`` for a HashGrid spec and ``{}`` otherwise.
Here they are named ``pos_table``, ``<mlp>.layers.<i>.weight`` (the same
(out, in) matrix) and ``surf_enc.<spec index>``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_MLPS = ("pos_mlp", "dir_mlp", "surf_mlp")


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX nested parameters (numpy or JAX arrays) -> state dict of CPU
    float32 tensors."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {"pos_table": t(tree["pos_table"])}
    for name in _MLPS:
        for i, layer in enumerate(tree[name]["layers"]):
            out[f"{name}.layers.{i}.weight"] = t(layer["w"])
    for i, spec in enumerate(tree["surf_enc"]):
        if "hash_table" in spec:
            out[f"surf_enc.{i}"] = t(spec["hash_table"])
    return out


def params_to_jax(
    state: Mapping[str, torch.Tensor], n_surf_specs: int
) -> dict[str, Any]:
    """State dict -> the JAX nested parameters as numpy arrays.
    ``n_surf_specs`` is the number of nested surface-encoding specs (the
    length of the ``surf_enc`` list, parameter-free specs included)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    tree: dict[str, Any] = {"pos_table": a(state["pos_table"])}
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
