"""Batched Amanatides-Woo voxel traversal on the host, the counterpart of
the JAX package's ``extract/voxel_traversal.py``. The data-dependent walk
runs once per extraction, as grid preparation: 3-D segments go through the
port's host library (``atmonr_tpu_torch.native``, OpenMP), 2-D ones through
the numpy walk, as in the JAX package. ``voxel_traversal_numpy`` is the
numpy walk for any D, the plain version the tests hold the library to."""

from __future__ import annotations

import numpy as np

from atmonr_tpu_torch import native


def voxel_traversal(u: np.ndarray, end: np.ndarray, unique_only: bool = True) -> np.ndarray:
    """All voxels crossed by the segments from ``u`` to ``end`` (unit voxels).

    Args:
        u: (N, D) start points in continuous voxel coordinates.
        end: (N, D) end points.
        unique_only: de-duplicate the returned voxels (sorted rows).

    Returns:
        (K, D) int32 voxel indices: with ``unique_only`` the sorted unique
        rows; else, for D = 3, every segment's voxels in walk order, segment
        after segment (``voxel_traversal_numpy``'s order for D = 2).
    """
    if u.shape != end.shape or u.ndim != 2:
        raise ValueError(f"start {u.shape} and end {end.shape} must be the same (N, D)")
    if u.shape[1] != 3:
        return voxel_traversal_numpy(u, end, unique_only)
    out, _ = native.voxel_traversal(u, end)
    return np.unique(out, axis=0) if unique_only else out


def voxel_traversal_numpy(u: np.ndarray, end: np.ndarray, unique_only: bool = True) -> np.ndarray:
    """All voxels crossed by the segments from ``u`` to ``end`` (unit
    voxels), by the numpy walk: all segments step together.

    Args:
        u: (N, D) start points in continuous voxel coordinates.
        end: (N, D) end points.
        unique_only: de-duplicate the returned voxels (sorted rows).

    Returns:
        (K, D) int32 voxel indices.

    Amanatides & Woo (1987), "A Fast Voxel Traversal Algorithm for Ray
    Tracing".
    """
    if u.shape != end.shape or u.ndim != 2:
        raise ValueError(f"start {u.shape} and end {end.shape} must be the same (N, D)")
    u = np.asarray(u, np.float64)
    end = np.asarray(end, np.float64)

    dists = np.linalg.norm(end - u, axis=-1)[:, None]
    v = (end - u) / dists

    vox_idx = np.floor(u).astype(np.int32)
    vox_idx_end = np.floor(end).astype(np.int32)
    sign_v = np.sign(v).astype(np.int32)
    sign_v_u = sign_v * u

    with np.errstate(divide="ignore", invalid="ignore"):
        tmax = np.abs((np.ceil(sign_v_u) - sign_v_u) / v)
        tdelta = np.abs(1.0 / v)
    tmax[np.isnan(tmax)] = np.inf
    tmax[vox_idx == vox_idx_end] = np.inf  # axes already at their destination

    registry = [np.unique(vox_idx, axis=0)]
    diff = (vox_idx - vox_idx_end) * sign_v
    done = (diff == 0).all(axis=-1) | (diff > 0).any(axis=-1)

    active = ~done
    while active.any():
        rows = np.where(active)[0]
        next_axis = np.argmin(tmax[rows], axis=-1)
        tmax[rows, next_axis] += tdelta[rows, next_axis]
        vox_idx[rows, next_axis] += sign_v[rows, next_axis]
        registry.append(vox_idx[rows].copy())
        diff = (vox_idx[rows] - vox_idx_end[rows]) * sign_v[rows]
        diff_nonneg = diff >= 0
        overshot = (diff > 0).any(axis=-1)
        # freeze the axes that have reached their destination coordinate
        tmax[rows] = np.where(diff_nonneg, np.inf, tmax[rows])
        newly_done = diff_nonneg.all(axis=-1) | overshot
        active[rows[newly_done]] = False

    out = np.concatenate(registry, axis=0)
    if unique_only:
        out = np.unique(out, axis=0)
    return out
