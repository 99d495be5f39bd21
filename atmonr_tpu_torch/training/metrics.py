"""Image reconstruction metrics: per-view PSNR and SSIM.

The port's own copy of the JAX package's ``training/metrics.py``: per-view
PSNR over the image dims with a shared data range, and SSIM with the
standard 11x11 Gaussian window (sigma 1.5, K1=0.01, K2=0.03) computed on the
valid (unpadded) region, matching torchmetrics' formulation. Host-side numpy:
metrics run once per epoch on fetched images, never in the training step.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve


def psnr_per_view(
    pred: np.ndarray, target: np.ndarray, data_range: float
) -> np.ndarray:
    """(V, H, W) images -> per-view PSNR in dB."""
    mse = np.mean((pred - target) ** 2, axis=(1, 2))
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(data_range**2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim_per_view(
    pred: np.ndarray,
    target: np.ndarray,
    data_range: float | None = None,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> np.ndarray:
    """(V, H, W) images -> per-view SSIM.

    ``data_range=None`` reproduces torchmetrics' default: the larger of the
    two images' (max - min).
    """
    if data_range is None:
        data_range = max(
            float(pred.max() - pred.min()), float(target.max() - target.min())
        )
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    # views smaller than the window (tiny test granules): shrink to the
    # largest odd size that fits so 'valid' convolution stays non-empty
    fit = min(kernel_size, pred.shape[1], pred.shape[2])
    kernel_size = fit if fit % 2 else fit - 1
    kernel = _gaussian_kernel(kernel_size, sigma)[None]

    def smooth(x):
        return fftconvolve(x, kernel, mode="valid")

    mu_p = smooth(pred)
    mu_t = smooth(target)
    mu_pp = smooth(pred * pred)
    mu_tt = smooth(target * target)
    mu_pt = smooth(pred * target)
    var_p = mu_pp - mu_p**2
    var_t = mu_tt - mu_t**2
    cov = mu_pt - mu_p * mu_t
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2)
    )
    return ssim_map.mean(axis=(1, 2))


def image_metrics(
    pred_img: np.ndarray, target_img: np.ndarray, max_i: float
) -> dict:
    """Per-view + mean PSNR/SSIM on (H, W, V) images, reference semantics:

    normalize by ``max_i``, clip the prediction to [0, 1], data range from
    the normalized target.
    """
    pred = (pred_img / max_i).transpose(2, 0, 1)
    target = (target_img / max_i).transpose(2, 0, 1)
    pred = np.clip(pred, 0.0, 1.0)
    data_range = float(target.max() - target.min())
    psnr = psnr_per_view(pred, target, data_range)
    ssim = ssim_per_view(pred, target)
    return {
        "PSNR": psnr.tolist(),
        "SSIM": ssim.tolist(),
        "PSNR_mean": float(np.nanmean(psnr)),
        "SSIM_mean": float(np.nanmean(ssim)),
    }
