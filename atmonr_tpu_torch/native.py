"""ctypes bindings of the port's host library, ``csrc/atmonr_native.cpp``
(multithreaded with OpenMP): the counterpart of the JAX package's
``native`` bindings, with the same signatures and return layouts, plus
``voxel_keys`` for the global grid and ``horizontal_grid_to_cartesian`` for
the regional grids' points.

The library is built with ``g++`` at first use (``_build.build_host``).
There is no numpy fallback: if it does not build or load, every entry point
raises ``RuntimeError`` with the compiler's output. The numpy versions stay
where they are, as the plain versions the tests hold these to:
``geo.wgs84.get_rays``, ``geo.wgs84.cartesian_to_horizontal`` /
``horizontal_to_cartesian`` / ``horizontal_grid_to_cartesian`` and
``extract.voxel_traversal.voxel_traversal_numpy``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from atmonr_tpu_torch import _build
from atmonr_tpu_torch.geo import wgs84

OUTSIDE_BOX = "a traversed voxel lies outside the rays' bounding box"

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "atmonr_build_rays": (None, [_F32P] * 5 + [ctypes.c_int64, ctypes.c_double,
                                               ctypes.c_double, ctypes.c_int] + [_F32P] * 3),
    "atmonr_h2c": (None, [_F64P] * 3 + [ctypes.c_int64] + [_F64P] * 3),
    "atmonr_c2h": (None, [_F64P] * 3 + [ctypes.c_int64] + [_F64P] * 3),
    "atmonr_grid_h2c": (None, [_F64P] * 6 + [ctypes.c_int64, _F64P, ctypes.c_int64, _F64P]),
    "atmonr_voxel_traversal": (None, [_F64P, _F64P, ctypes.c_int64, _I64P, _I32P, _I32P]),
    "atmonr_voxel_keys": (ctypes.c_int64, [_F64P, _F64P, ctypes.c_int64, _I64P, _I64P, _I64P,
                                           _I64P, _I32P]),
    "atmonr_num_threads": (ctypes.c_int, []),
}


def _lib() -> ctypes.CDLL:
    """The library, built and loaded at first use, its functions declared
    (declaring again is harmless)."""
    lib = _build.load_host("atmonr_native")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _flat(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype).reshape(-1)


def _segments(u, end) -> tuple[np.ndarray, np.ndarray]:
    u = np.ascontiguousarray(u, np.float64)
    end = np.ascontiguousarray(end, np.float64)
    if u.shape != end.shape or u.ndim != 2 or u.shape[1] != 3:
        raise ValueError(f"start {u.shape} and end {end.shape} must be the same (N, 3)")
    return u, end


def _offsets(counts: np.ndarray) -> np.ndarray:
    offsets = np.zeros(counts.shape[0], np.int64)
    np.cumsum(counts[:-1], dtype=np.int64, out=offsets[1:])
    return offsets


def num_threads() -> int:
    """OpenMP's thread count in the library."""
    return int(_lib().atmonr_num_threads())


def build_rays(lat, lon, alt, thetav, phiv, ray_origin_height: float, tol: float = 10.0,
               max_iters: int = 20) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rays from viewing geometry, one OpenMP task per pixel: (N, 3)
    float32 origins at ``ray_origin_height``, (N, 3) directions and (N,)
    lengths, as ``geo.wgs84.get_rays``. Each ray stops its origin solve on
    its own where ``get_rays`` stops all of them together, so origins and
    lengths differ from it within the 10 m tolerance (by up to 25 m)."""
    lib = _lib()
    lat32, lon32, alt32 = _flat(lat, np.float32), _flat(lon, np.float32), _flat(alt, np.float32)
    th32, ph32 = _flat(thetav, np.float32), _flat(phiv, np.float32)
    n = lat32.shape[0]
    if any(a.shape[0] != n for a in (lon32, alt32, th32, ph32)):
        raise ValueError("lat, lon, alt, thetav and phiv must have the same size")
    origins = np.empty((n, 3), np.float32)
    dirs = np.empty((n, 3), np.float32)
    lens = np.empty((n,), np.float32)
    lib.atmonr_build_rays(
        _ptr(lat32, _F32P), _ptr(lon32, _F32P), _ptr(alt32, _F32P), _ptr(th32, _F32P),
        _ptr(ph32, _F32P), n, float(ray_origin_height), float(tol), int(max_iters),
        _ptr(origins, _F32P), _ptr(dirs, _F32P), _ptr(lens, _F32P),
    )
    return origins, dirs, lens


def _bulk(fn_name: str, a, b, c) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    shape = np.shape(a)
    a, b, c = _flat(a, np.float64), _flat(b, np.float64), _flat(c, np.float64)
    n = a.shape[0]
    if b.shape[0] != n or c.shape[0] != n:
        raise ValueError("the three coordinates must have the same size")
    out = [np.empty(n) for _ in range(3)]
    getattr(_lib(), fn_name)(_ptr(a, _F64P), _ptr(b, _F64P), _ptr(c, _F64P), n,
                             *(_ptr(o, _F64P) for o in out))
    return tuple(o.reshape(shape) for o in out)


def cartesian_to_horizontal(x, y, z) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bulk float64 ECEF -> geodetic (lat, lon, alt)."""
    return _bulk("atmonr_c2h", x, y, z)


def horizontal_to_cartesian(lat, lon, alt) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bulk float64 geodetic -> ECEF (x, y, z)."""
    return _bulk("atmonr_h2c", lat, lon, alt)


def horizontal_grid_to_cartesian(lat, lon, alt) -> np.ndarray:
    """A horizontal (H, W) lat/lon grid [deg] times an (na,) altitude
    ladder [m] -> (H, W, na, 3) float64 ECEF, C-contiguous, bit-equal to
    ``geo.wgs84.horizontal_grid_to_cartesian``: the per-pixel terms in numpy
    as there (``horizontal_grid_terms``), their expansion over the ladder in
    the library, one OpenMP task per pixel. Counter:
    ``horizontal_grid_to_cartesian.points``, the points written."""
    lib = _lib()
    terms = wgs84.horizontal_grid_terms(lat, lon)
    shape = terms[0].shape
    terms = [_flat(np.broadcast_to(t, shape), np.float64) for t in terms]
    alt = np.asarray(alt, np.float64)
    ladder = _flat(alt, np.float64)
    out = np.empty(shape + alt.shape + (3,), np.float64)
    p, na = terms[0].shape[0], ladder.shape[0]
    if p and na:
        lib.atmonr_grid_h2c(*(_ptr(t, _F64P) for t in terms), p, _ptr(ladder, _F64P), na,
                            _ptr(out, _F64P))
    horizontal_grid_to_cartesian.points += p * na
    return out


horizontal_grid_to_cartesian.points = 0


def voxel_traversal(u: np.ndarray, end: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All voxels crossed by the segments ``u`` -> ``end`` ((N, 3),
    continuous voxel coordinates), one OpenMP task per segment: a pass that
    counts each segment's voxels, then one that writes them at the prefix
    sums of the counts. Returns (voxels (total, 3) int32, segment after
    segment, each in walk order; counts (N,) int32)."""
    lib = _lib()
    u, end = _segments(u, end)
    n = u.shape[0]
    counts = np.zeros(n, np.int32)
    lib.atmonr_voxel_traversal(_ptr(u, _F64P), _ptr(end, _F64P), n, None, None,
                               _ptr(counts, _I32P))
    offsets = _offsets(counts)
    vox = np.empty((int(counts.sum(dtype=np.int64)), 3), np.int32)
    lib.atmonr_voxel_traversal(_ptr(u, _F64P), _ptr(end, _F64P), n, _ptr(offsets, _I64P),
                               _ptr(vox, _I32P), _ptr(counts, _I32P))
    return vox, counts


def voxel_keys(u: np.ndarray, end: np.ndarray, lo: np.ndarray, width: np.ndarray) -> np.ndarray:
    """The walk of ``voxel_traversal`` with one int64 per voxel in place of
    its row: ``((v0 - lo0) * width1 + (v1 - lo1)) * width2 + (v2 - lo2)``,
    which orders the keys as the rows order lexicographically. Returns the
    (total,) keys, segment after segment. Raises ``ValueError`` when a voxel
    lies outside the box ``[lo, lo + width)``."""
    lib = _lib()
    u, end = _segments(u, end)
    lo = _flat(lo, np.int64)
    width = _flat(width, np.int64)
    if lo.shape != (3,) or width.shape != (3,) or np.any(width <= 0):
        raise ValueError(f"lo {lo} and width {width} must be three integers, width positive")
    n = u.shape[0]
    counts = np.zeros(n, np.int32)
    args = (_ptr(u, _F64P), _ptr(end, _F64P), n, _ptr(lo, _I64P), _ptr(width, _I64P))
    lib.atmonr_voxel_keys(*args, None, None, _ptr(counts, _I32P))
    offsets = _offsets(counts)
    keys = np.empty(int(counts.sum(dtype=np.int64)), np.int64)
    outside = lib.atmonr_voxel_keys(*args, _ptr(offsets, _I64P), _ptr(keys, _I64P),
                                    _ptr(counts, _I32P))
    if outside:
        raise ValueError(OUTSIDE_BOX)
    return keys
