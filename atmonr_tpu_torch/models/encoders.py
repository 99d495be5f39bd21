"""Input encoders: spherical harmonics, identity, and composites.

Counterpart of the JAX package's ``models/encoders.py``:

- ``spherical_harmonics``: tiny-cuda-nn's real SH basis, degrees 1-4 (bands
  0-3), in tcnn's component order and input convention (inputs treated as
  [0,1]-scaled and mapped by ``x*2-1``).
- ``init_composite`` / ``apply_composite``: config-driven slicing of the
  input dims into nested SphericalHarmonics, Identity and HashGrid
  encodings. The NeRF ``Frequency`` encoding is still to be ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from atmonr_tpu_torch.models import hash_grid as hg


def _sh_l0(x, y, z):
    return [torch.full_like(x, 0.28209479177387814)]


def _sh_l1(x, y, z):
    return [
        -0.48860251190291987 * y,
        0.48860251190291992 * z,
        -0.48860251190291987 * x,
    ]


def _sh_l2(x, y, z):
    xy, yz, xz = x * y, y * z, x * z
    x2, y2, z2 = x * x, y * y, z * z
    return [
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
    ]


def _sh_l3(x, y, z):
    xy, yz, xz = x * y, y * z, x * z
    x2, y2, z2 = x * x, y * y, z * z
    return [
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]


def spherical_harmonics(
    v: torch.Tensor, degree: int, tcnn_input_convention: bool = True
) -> torch.Tensor:
    """Real spherical-harmonics basis of ``v`` (..., 3), tcnn component
    order; ``degree`` follows tcnn (degree**2 outputs)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree must be in 1..4, got {degree}")
    if tcnn_input_convention:
        v = v * 2.0 - 1.0
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    comps = _sh_l0(x, y, z)
    if degree >= 2:
        comps += _sh_l1(x, y, z)
    if degree >= 3:
        comps += _sh_l2(x, y, z)
    if degree >= 4:
        comps += _sh_l3(x, y, z)
    return torch.stack(comps, dim=-1)


@dataclass(frozen=True)
class EncoderSpec:
    """One nested entry of a composite encoding config (tcnn schema).

    ``otype`` in {"SphericalHarmonics", "Identity", "HashGrid"};
    ``n_dims_to_encode`` slices the input (None = all remaining dims).
    """

    otype: str
    n_dims_to_encode: int | None = None
    options: dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_config(cfg: dict) -> "EncoderSpec":
        cfg = dict(cfg)
        otype = cfg.pop("otype")
        n_dims = cfg.pop("n_dims_to_encode", None)
        return EncoderSpec(otype=otype, n_dims_to_encode=n_dims, options=cfg)


def _not_ported(otype: str) -> NotImplementedError:
    if otype == "Frequency":
        return NotImplementedError(
            "the Frequency encoding comes with the NeRF pipeline "
            "(ROADMAP.md queue 1, 'NeRF pipeline')"
        )
    return NotImplementedError(otype)


def _spans(specs: Sequence[EncoderSpec], n_input_dims: int):
    """(spec, first input dim, number of dims) per nested encoding."""
    consumed = 0
    for spec in specs:
        n_dims = spec.n_dims_to_encode
        if n_dims is None:
            n_dims = n_input_dims - consumed
        yield spec, consumed, n_dims
        consumed += n_dims
    if consumed > n_input_dims:
        raise ValueError(f"encodings take {consumed} dims of {n_input_dims}")


def composite_output_dim(specs: Sequence[EncoderSpec], n_input_dims: int) -> int:
    """Output dimensionality of a composite encoding over ``n_input_dims``."""
    total = 0
    for spec, _, n_dims in _spans(specs, n_input_dims):
        if spec.otype == "SphericalHarmonics":
            total += int(spec.options["degree"]) ** 2
        elif spec.otype == "Identity":
            total += n_dims
        elif spec.otype == "HashGrid":
            total += int(spec.options["n_levels"]) * int(
                spec.options["n_features_per_level"]
            )
        else:
            raise _not_ported(spec.otype)
    return total


def parse_encoding_config(cfg: dict) -> list[EncoderSpec]:
    """Parse a tcnn-style encoding config (possibly ``Composite``)."""
    if cfg.get("otype") == "Composite":
        return [EncoderSpec.from_config(c) for c in cfg["nested"]]
    return [EncoderSpec.from_config(cfg)]


def hash_grid_configs(
    specs: Sequence[EncoderSpec], n_input_dims: int
) -> dict[int, hg.HashGridConfig]:
    """The HashGrid configs of a composite, by spec index."""
    return {
        i: hg.HashGridConfig.from_options(spec.options, n_dims)
        for i, (spec, _, n_dims) in enumerate(_spans(specs, n_input_dims))
        if spec.otype == "HashGrid"
    }


def init_composite(
    specs: Sequence[EncoderSpec],
    n_input_dims: int,
    generator: torch.Generator,
    device: torch.device,
) -> dict[int, torch.Tensor]:
    """Hash tables of a composite encoding, by spec index."""
    return {
        i: hg.init_hash_table(cfg, generator, device)
        for i, cfg in hash_grid_configs(specs, n_input_dims).items()
    }


def apply_composite(
    tables: dict[int, torch.Tensor],
    specs: Sequence[EncoderSpec],
    x: torch.Tensor,
) -> torch.Tensor:
    """Apply a composite encoding to (M, n_input_dims) inputs; ``tables``
    holds the hash table of each HashGrid spec, by spec index."""
    outs = []
    for i, (spec, start, n_dims) in enumerate(_spans(specs, x.shape[-1])):
        xs = x[..., start : start + n_dims]
        if spec.otype == "SphericalHarmonics":
            outs.append(spherical_harmonics(xs, int(spec.options["degree"])))
        elif spec.otype == "Identity":
            outs.append(xs)
        elif spec.otype == "HashGrid":
            cfg = hg.HashGridConfig.from_options(spec.options, n_dims)
            outs.append(hg.hash_encode(tables[i], xs, cfg))
        else:
            raise _not_ported(spec.otype)
    return torch.cat(outs, dim=-1)
