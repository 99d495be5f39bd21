"""Orbit renderer for extracted extinction volumes, in plain PyTorch on
the card: the counterpart of the JAX package's ``extract/orbit_render.py``.

Pinhole rays, trilinear sampling of the voxel volume and Beer-Lambert
emission-absorption compositing (a white medium on black), so the
train -> extract -> video workflow needs no native renderer. JAX evaluates
a frame under ``jax.jit``, where XLA rounds some products differently, so
frames agree with JAX's to float32 rounding, not bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from atmonr_tpu_torch.utils.device import resolve_device


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)``'s formula: ``start * (1 - s) +
    stop * s`` with ``s = i * (1 / (num - 1))`` (the reciprocal rounded to
    float32, as XLA turns the division), and ``stop`` itself as the last
    value. XLA:CPU also contracts parts of it into FMAs, so a value may be
    an ulp off JAX's."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) * (1.0 / div)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _trilinear_sample(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample an (X, Y, Z) volume at (..., 3) voxel-space points; zero
    outside the volume. The cell's flat index is computed once and each
    corner adds its constant offset to it."""
    shp = torch.tensor(vol.shape, dtype=torch.float32, device=vol.device)
    inside = torch.all((pts >= 0.0) & (pts <= shp - 1.0), dim=-1)
    base = torch.minimum(torch.clamp(torch.floor(pts), min=0.0), shp - 2.0)
    frac = torch.clamp(pts - base, 0.0, 1.0)
    weights = (1.0 - frac, frac)  # (weight of the corner's 0 side, of its 1 side)
    strides = (vol.shape[1] * vol.shape[2], vol.shape[2], 1)
    base = base.long()
    cell = base[..., 0] * strides[0] + base[..., 1] * strides[1] + base[..., 2]
    flat = vol.reshape(-1)
    acc = torch.zeros(pts.shape[:-1], dtype=vol.dtype, device=vol.device)
    for corner in range(8):
        bits = [(corner >> d) & 1 for d in range(3)]
        w = weights[bits[0]][..., 0] * weights[bits[1]][..., 1] * weights[bits[2]][..., 2]
        offset = sum(b * st for b, st in zip(bits, strides))
        acc = acc + w * flat[cell + offset]
    return torch.where(inside, acc, 0.0)


def _camera_rays(
    eye: torch.Tensor, center: torch.Tensor, width: int, height: int, fov_deg: float
) -> torch.Tensor:
    """(H, W, 3) unit directions of pinhole rays, y-up look-at."""
    dev = eye.device
    fwd = center - eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.clamp(torch.linalg.vector_norm(right), min=1e-9)
    cam_up = torch.linalg.cross(right, fwd)
    tan_h = torch.tan(torch.deg2rad(torch.tensor(fov_deg, device=dev)) / 2.0)
    one = torch.tensor(1.0, device=dev)
    xs = _linspace(-one, one, width) * tan_h
    ys = _linspace(one, -one, height) * tan_h * (height / width)
    dirs = (
        fwd[None, None]
        + xs[None, :, None] * right[None, None]
        + ys[:, None, None] * cam_up[None, None]
    )
    return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


@torch.no_grad()
def render_frame(
    vol: torch.Tensor,
    eye: torch.Tensor,
    center: torch.Tensor,
    width: int = 640,
    height: int = 480,
    n_samples: int = 192,
    fov_deg: float = 45.0,
    density_scale: float = 1.0,
) -> torch.Tensor:
    """One orbit frame on ``vol``'s device: (H, W) float32 brightness in
    [0, 1] by emission-absorption compositing of ``n_samples`` samples per
    ray through the voxel volume."""
    dirs = _camera_rays(eye, center, width, height, fov_deg)
    diag = torch.linalg.vector_norm(torch.tensor(vol.shape, dtype=torch.float32, device=vol.device))
    t0 = torch.clamp(torch.linalg.vector_norm(eye - center) - diag, min=0.0)
    ts = _linspace(t0, t0 + 2.0 * diag, n_samples)
    dt = (ts[1] - ts[0]) * density_scale
    pts = eye[None, None, None] + dirs[:, :, None] * ts[None, None, :, None]
    sigma = _trilinear_sample(vol, pts)  # (H, W, N)
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return torch.clamp(torch.sum(alpha * trans, dim=-1), 0.0, 1.0)


def orbit_camera(
    shape: tuple[int, int, int],
    k: int,
    num_frames: int,
    orbit_radius_factor: float = 1.3,
    view_height_factor: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """(eye, center) of frame ``k`` of ``num_frames``, float32: a circle of
    radius ``orbit_radius_factor * |shape|`` at height
    ``view_height_factor * |shape|``, looking at the volume's center (the
    reference's camera path)."""
    shp = np.asarray(shape, np.float64)
    radius = orbit_radius_factor * float(np.linalg.norm(shp))
    v_height = view_height_factor * float(np.linalg.norm(shp))
    theta = 2.0 * np.pi * k / max(num_frames, 1)
    eye = np.asarray(
        [shp[0] / 2.0 + radius * np.cos(theta), v_height, shp[2] / 2.0 + radius * np.sin(theta)],
        np.float32,
    )
    return eye, np.asarray(shp / 2.0, np.float32)


def render_orbit(
    sigma: np.ndarray,
    num_frames: int,
    width: int = 640,
    height: int = 480,
    n_samples: int = 192,
    orbit_radius_factor: float = 1.3,
    view_height_factor: float = 0.5,
    density_scale: float = 1.0,
    device: str | torch.device | None = None,
):
    """Yield ``num_frames`` (H, W) uint8 frames orbiting the (X, Y, Z)
    volume ``sigma`` (NaN read as 0), rendered on ``device`` (``cuda``
    unless the caller names another)."""
    dev = resolve_device(device)
    vol = torch.from_numpy(np.nan_to_num(sigma).astype(np.float32)).to(dev)
    for k in range(num_frames):
        eye, center = orbit_camera(
            sigma.shape, k, num_frames, orbit_radius_factor, view_height_factor
        )
        frame = render_frame(
            vol,
            torch.from_numpy(eye).to(dev),
            torch.from_numpy(center).to(dev),
            width=width,
            height=height,
            n_samples=n_samples,
            density_scale=density_scale,
        )
        yield (frame * 255.0).to(torch.uint8).cpu().numpy()


def write_ppm(path: str | Path, frame_u8: np.ndarray) -> None:
    """Binary P5 (grayscale) PGM, which ffmpeg reads directly."""
    h, w = frame_u8.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(frame_u8).tobytes())
