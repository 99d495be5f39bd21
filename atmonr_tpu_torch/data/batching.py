"""Device-side batching over the device-resident ray tensors, as in the JAX
package's ``data/batching.py``: a per-epoch permutation drawn on the device
and an index gather per step, with no host<->device traffic in the steady
state."""

from __future__ import annotations

from typing import Mapping

import torch


def num_batches(n_rays: int, batch_size: int, drop_last: bool = False) -> int:
    if drop_last:
        return n_rays // batch_size
    return -(-n_rays // batch_size)


def epoch_permutation(
    generator: torch.Generator, n_rays: int, batch_size: int
) -> torch.Tensor:
    """(num_full_batches * batch_size,) shuffled ray indices (int64), drawn
    from ``generator`` on its own device. The trailing partial batch is
    dropped."""
    nb = n_rays // batch_size
    perm = torch.randperm(n_rays, generator=generator, device=generator.device)
    return perm[: nb * batch_size]


def sequential_indices(
    n_rays: int, batch_size: int, device: str | torch.device = "cpu"
) -> torch.Tensor:
    """Unshuffled padded index vector for evaluation sweeps: padded with the
    last index to whole batches; ``valid_mask`` marks the real entries."""
    nb = num_batches(n_rays, batch_size)
    idx = torch.arange(nb * batch_size, device=device)
    return torch.clamp(idx, max=n_rays - 1)


def valid_mask(
    n_rays: int, batch_size: int, device: str | torch.device = "cpu"
) -> torch.Tensor:
    nb = num_batches(n_rays, batch_size)
    return torch.arange(nb * batch_size, device=device) < n_rays


def gather_batch(
    rays: Mapping[str, torch.Tensor], idx: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Gather a ray batch by index; adds the ``"idx"`` field."""
    batch = {k: v[idx] for k, v in rays.items()}
    batch["idx"] = idx
    return batch


def batch_at_step(
    rays: Mapping[str, torch.Tensor],
    perm: torch.Tensor,
    step_in_epoch: int,
    batch_size: int,
) -> dict[str, torch.Tensor]:
    """Slice the step's indices out of the epoch permutation and gather the
    batch."""
    idx = perm[step_in_epoch * batch_size : (step_in_epoch + 1) * batch_size]
    return gather_batch(rays, idx)
