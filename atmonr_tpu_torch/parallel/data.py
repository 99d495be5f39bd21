"""Multi-host ray loading: each rank reads and builds only its own rows of
the ray set. The counterpart of the JAX package's ``parallel/data.py``.

The data axis gives data index d the contiguous rows
``[d * n / n_data, (d + 1) * n / n_data)`` of the ray set trimmed to a
multiple of ``n_data`` (the rows the JAX package's ``NamedSharding(mesh,
P("data"))`` gives the devices of data index d); ranks along "sample" hold
the same rows. One process drives one device here, so a host's slice is
its rank's block.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from atmonr_tpu_torch.parallel.mesh import in_mesh, mesh_axis, mesh_shape


def trimmed_ray_count(n_total: int, mesh: DeviceMesh, axis: str = "data") -> int:
    """The ray count trimmed to a multiple of the ``axis`` size (the
    remainder is fewer rays than the axis has ranks)."""
    n_shards = mesh_shape(mesh)[axis]
    return (n_total // n_shards) * n_shards


def data_rows(n_total: int, n_shards: int, index: int) -> slice:
    """The contiguous rows of shard ``index`` of ``n_shards``, over the ray
    count trimmed to a multiple of ``n_shards``."""
    per = n_total // n_shards
    return slice(index * per, (index + 1) * per)


def host_ray_slice(n_total: int, mesh: DeviceMesh, axis: str = "data") -> slice:
    """The rows this rank must materialize; empty for a rank outside the
    mesh."""
    if not in_mesh(mesh):
        return slice(0, 0)
    ax = mesh_axis(mesh, axis)
    return data_rows(n_total, ax.size, ax.index)


def shard_rays_from_hosts(
    local_rays: Mapping[str, np.ndarray],
    n_total: int,
    mesh: DeviceMesh,
    device: str | torch.device,
    axis: str = "data",
) -> dict[str, torch.Tensor]:
    """This rank's ray store on ``device``, from its rows alone.

    Args:
        local_rays: this rank's rows, exactly
            ``host_rays[k][host_ray_slice(n_total, mesh)]`` for each array.
        n_total: the untrimmed ray count (every rank passes the same).
    """
    sl = host_ray_slice(n_total, mesh, axis)
    expect = sl.stop - sl.start
    out = {}
    for k, v in local_rays.items():
        if v.shape[0] != expect:
            raise ValueError(f"{k}: {v.shape[0]} rows, this rank owns {expect}")
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out
