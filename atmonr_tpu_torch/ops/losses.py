"""Radiance reconstruction losses, as in the JAX package's
``ops/losses.py``. All take the scene max-intensity normalizer ``max_i``;
``pred`` and ``gt`` are per-ray scalars."""

from __future__ import annotations

import torch


def dark_loss(pred, gt, max_i: float):
    """NeRF-in-the-dark relative MSE; the denominator carries no gradient."""
    return torch.mean(((pred - gt) / (pred.detach() + 1e-3 * max_i)) ** 2)


def hdr_loss(pred, gt, max_i: float):
    """Log-space MSE."""
    return torch.mean(
        (torch.log(gt + 1e-3 * max_i) - torch.log(pred + 1e-3 * max_i)) ** 2
    )


def l1_loss(pred, gt, max_i: float):
    return torch.mean(torch.abs(pred / max_i - gt / max_i))


def l1_plus_hdr_loss(pred, gt, max_i: float):
    return l1_loss(pred, gt, max_i) + 0.2 * hdr_loss(pred, gt, max_i)


def mse_loss(pred, gt, max_i: float):
    return torch.mean((pred / max_i - gt / max_i) ** 2)


def mse_plus_hdr_loss(pred, gt, max_i: float):
    return mse_loss(pred, gt, max_i) + 0.2 * hdr_loss(pred, gt, max_i)


LOSSES = {
    "dark": dark_loss,
    "hdr": hdr_loss,
    "l1": l1_loss,
    "l1_plus_hdr": l1_plus_hdr_loss,
    "mse": mse_loss,
    "mse_plus_hdr": mse_plus_hdr_loss,
}


def get_loss(name: str):
    """Loss registry lookup."""
    return LOSSES[name.lower()]
