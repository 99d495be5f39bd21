"""The port's orbit renderer against the JAX package's, on the CPU.

JAX renders a frame under ``jax.jit``, where XLA:CPU rounds the
linspaces' products through FMAs; torch rounds each op. The brightness of a
frame therefore agrees to atol 1e-5 (measured ~1.5e-6 at 64x48x32), and the
uint8 frames, which truncate ``255 * brightness``, within one level."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmonr_tpu.extract import orbit_render as jor
from atmonr_tpu_torch.extract import orbit_render as tor

W, H, N = 64, 48, 32


def _volume(seed: int, shape=(20, 12, 16)) -> np.ndarray:
    """A random field with a denser block inside, zero near the faces."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    vol[2:-2, 2:-2, 2:-2] = rng.uniform(0.0, 0.2, tuple(s - 4 for s in shape))
    vol[6:12, 4:8, 5:11] += 0.5
    return vol


@pytest.mark.parametrize("linspace", [(-1.0, 1.0, 64), (1.0, -1.0, 48), (3.5, 97.25, 32)])
def test_linspace_within_an_ulp_of_jnp(linspace):
    start, stop, n = linspace
    want = np.asarray(jnp.linspace(start, stop, n))
    got = tor._linspace(torch.tensor(start), torch.tensor(stop), n).numpy()
    assert got[0] == want[0] and got[-1] == want[-1]
    ulp = np.spacing(np.float32(max(abs(start), abs(stop))))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_render_frame_matches_jax(k):
    """Four orbit positions of a random volume, at 64x48 with 32 samples
    a ray, JAX's frame jitted as its ``render_orbit`` jits it: atol 1e-5."""
    vol = _volume(0)
    eye, center = tor.orbit_camera(vol.shape, k, 4)
    frame_fn = jax.jit(
        lambda v, e: jor.render_frame(v, e, jnp.asarray(center), width=W, height=H, n_samples=N)
    )
    want = np.asarray(frame_fn(jnp.asarray(vol), jnp.asarray(eye)))
    got = tor.render_frame(
        torch.from_numpy(vol), torch.from_numpy(eye), torch.from_numpy(center),
        width=W, height=H, n_samples=N,
    ).numpy()
    assert got.shape == (H, W) and got.dtype == np.float32
    assert want.max() > 0.5, "the volume must be visible"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_camera_rays_match_jax():
    eye, center = tor.orbit_camera((20, 12, 16), 1, 5)
    want = np.asarray(jax.jit(lambda e: jor._camera_rays(e, jnp.asarray(center), W, H, 45.0))(
        jnp.asarray(eye)))
    got = tor._camera_rays(torch.from_numpy(eye), torch.from_numpy(center), W, H, 45.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("density_scale", [1.0, 3.0])
def test_orbit_frames_match_jax(density_scale):
    """Five uint8 frames of ``render_orbit``: within one level of JAX's."""
    vol = _volume(1)
    want = list(jor.render_orbit(vol, 5, width=W, height=H, n_samples=N,
                                 density_scale=density_scale))
    got = list(tor.render_orbit(vol, 5, width=W, height=H, n_samples=N,
                                density_scale=density_scale, device="cpu"))
    assert len(got) == 5
    for a, b in zip(got, want):
        assert a.shape == (H, W) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert not np.array_equal(got[0], got[1]), "orbiting must change the view"
    assert (got[0] == 0).any() and got[0].max() > 32


def test_orbit_render_reads_nan_as_empty():
    vol = np.full((8, 8, 8), np.nan, np.float32)
    vol[2:6, 2:6, 2:6] = 1.0
    (want,) = jor.render_orbit(vol, 1, width=32, height=24)
    (got,) = tor.render_orbit(vol, 1, width=32, height=24, device="cpu")
    assert got.max() > 0
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    (clean,) = tor.render_orbit(np.nan_to_num(vol), 1, width=32, height=24, device="cpu")
    np.testing.assert_array_equal(got, clean)


def test_write_ppm_byte_equal(tmp_path):
    frame = np.random.default_rng(2).integers(0, 256, (H, W), dtype=np.uint8)
    jor.write_ppm(tmp_path / "j.ppm", frame)
    tor.write_ppm(tmp_path / "t.ppm", frame)
    raw = (tmp_path / "t.ppm").read_bytes()
    assert raw == (tmp_path / "j.ppm").read_bytes()
    assert raw.startswith(b"P5\n64 48\n255\n") and len(raw) == len(b"P5\n64 48\n255\n") + W * H


def test_render_orbit_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tor.render_orbit(_volume(3), 1, width=8, height=6))
