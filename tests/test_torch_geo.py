"""The port's geodesy for the extraction grids against the JAX package's,
on the CPU: Vincenty's inverse and direct solves, the direction-vector to
horizontal-angle conversion and the spherical-Earth helpers. Both packages
compute in numpy float64 (the JAX package with ``xp=np``), so every result
must be equal bit for bit."""

import numpy as np
import pytest

from atmonr_tpu.geo import spherical as jsph
from atmonr_tpu.geo import wgs84 as jw
from atmonr_tpu_torch.geo import spherical as tsph
from atmonr_tpu_torch.geo import wgs84 as tw


def _latlon_pairs(n: int, seed: int, spread: float):
    """Random start points and end points within ``spread`` degrees."""
    rng = np.random.default_rng(seed)
    lat1 = rng.uniform(-75, 75, n)
    lon1 = rng.uniform(-179, 179, n)
    lat2 = np.clip(lat1 + rng.uniform(-spread, spread, n), -80, 80)
    lon2 = lon1 + rng.uniform(-spread, spread, n)
    return np.stack([lat1, lon1]), np.stack([lat2, lon2])


def _equal(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("spread", [0.01, 1.0, 20.0], ids=["1km", "100km", "2000km"])
@pytest.mark.parametrize("kind", ["array", "tuple"])
def test_vincenty_distance_matches_jax(spread, kind):
    """Distance and both azimuths of 64 random pairs."""
    p1, p2 = _latlon_pairs(64, 0, spread)
    if kind == "tuple":
        p1, p2 = tuple(p1), tuple(p2)
    _equal(tw.vincenty_distance(p1, p2), jw.vincenty_distance(p1, p2, xp=np))


@pytest.mark.parametrize("kind", ["array", "tuple"])
def test_vincenty_point_along_geodesic_matches_jax(kind):
    """Destinations (lat, lon) and their azimuths, over broadcast starts,
    azimuths and distances up to 500 km, in both container kinds."""
    rng = np.random.default_rng(1)
    start = np.stack([rng.uniform(-70, 70, (8, 1)), rng.uniform(-179, 179, (8, 1))])
    azi = rng.uniform(-180, 180, (8, 1))
    dist = rng.uniform(0, 5e5, (1, 16))
    if kind == "tuple":
        start = (start[0], start[1])
    t_pt, t_azi = tw.vincenty_point_along_geodesic(start, azi, dist)
    j_pt, j_azi = jw.vincenty_point_along_geodesic(start, azi, dist, xp=np)
    assert type(t_pt) is type(j_pt)
    _equal(t_pt, j_pt)
    np.testing.assert_array_equal(t_azi, j_azi)


def test_vincenty_round_trip():
    """Walking the inverse solve's distance along its azimuth reaches the
    end point (to 1e-8 degrees)."""
    p1, p2 = _latlon_pairs(32, 2, 5.0)
    s, a1, _ = tw.vincenty_distance(p1, p2)
    p2b, _ = tw.vincenty_point_along_geodesic(p1, a1, s)
    np.testing.assert_allclose(p2b, p2, atol=1e-8)


def test_vincenty_raises_without_convergence():
    """Nearly antipodal points do not converge; both packages raise."""
    p1, p2 = np.array([[0.0], [0.0]]), np.array([[0.5], [179.7]])
    with pytest.raises(Warning, match="Exceeded"):
        jw.vincenty_distance(p1, p2, xp=np)
    with pytest.raises(Warning, match="Exceeded"):
        tw.vincenty_distance(p1, p2)


def test_dirvecs_to_horizontal_coords_matches_jax():
    rng = np.random.default_rng(3)
    theta = rng.uniform(0, 80, (5, 7))
    phi = rng.uniform(-180, 180, (5, 7))
    dirs = tw.horizontal_coords_to_dirvecs(theta, phi)
    _equal(tw.dirvecs_to_horizontal_coords(dirs), jw.dirvecs_to_horizontal_coords(dirs, xp=np))


def test_spherical_helpers_match_jax():
    """WGS-84 <-> sphere both ways, and the radial stretch for points above
    and below sea level, on points from 100 m below to 20 km above."""
    rng = np.random.default_rng(4)
    lat, lon = rng.uniform(-80, 80, 500), rng.uniform(-180, 180, 500)
    alt = rng.uniform(-100, 2e4, 500)
    xyz = np.stack(tw.horizontal_to_cartesian(lat, lon, alt), axis=-1)
    s_t, s_j = tsph.wgs_84_to_spherical(xyz), jsph.wgs_84_to_spherical(xyz, xp=np)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(tsph.spherical_to_wgs84(s_t), jsph.spherical_to_wgs84(s_j, xp=np))
    for stretch in (12.0, 1.0 / 12.0):
        np.testing.assert_array_equal(
            tsph.stretch_above_sea_level(s_t, stretch),
            jsph.stretch_above_sea_level(s_j, stretch, xp=np),
        )
    # the round trip is the identity to float64 rounding
    np.testing.assert_allclose(tsph.spherical_to_wgs84(s_t), xyz, rtol=1e-15, atol=1e-8)


def _pixels(dtype) -> tuple[np.ndarray, np.ndarray]:
    """A (6, 5) lat/lon grid of random pixels with the poles, the
    antimeridian from both sides and the zeros that NaN pixels become."""
    rng = np.random.default_rng(5)
    lat = rng.uniform(-90, 90, (6, 5))
    lon = rng.uniform(-180, 180, (6, 5))
    lat[0, :4], lon[0, :4] = [90.0, -90.0, 0.0, 0.0], [180.0, -180.0, 0.0, 0.0]
    return lat.astype(dtype), lon.astype(dtype)


# the regional grids' ladders: np.arange(min_alt, max_alt + step / 2, step)
_LADDERS = {
    "default": np.arange(0.0, 20000.0 + 12.5, 25.0),
    "min-max": np.arange(1000.0, 6000.0 + 250.0, 500.0),
    "one": np.arange(0.0, 0.0 + 500.0, 1000.0),
}


@pytest.mark.parametrize("ladder", list(_LADDERS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_horizontal_grid_to_cartesian_equals_the_repeated_grid(dtype, ladder):
    """Bit-equal to ``horizontal_to_cartesian`` of the grid repeated over
    the ladder, each input cast to float64: (H, W, na, 3), C-contiguous."""
    lat, lon = _pixels(dtype)
    alt = _LADDERS[ladder]
    shape = lat.shape + alt.shape
    rep = [np.repeat(a[:, :, None], alt.shape[0], axis=2).astype(np.float64) for a in (lat, lon)]
    want = np.stack(
        tw.horizontal_to_cartesian(*rep, np.broadcast_to(alt, shape).astype(np.float64)), axis=-1
    )
    got = tw.horizontal_grid_to_cartesian(lat, lon, alt)
    assert got.shape == shape + (3,) and got.dtype == np.float64 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
