"""(data, sample) meshes over ``torch.distributed``: the counterpart of the
JAX package's ``parallel/mesh.py``.

One process drives one device. A mesh is a ``DeviceMesh`` with the
dimensions ``("data", "sample")`` over ranks of the process group:

- ``data``: rays are i.i.d., so each data index holds its own contiguous
  rows of the ray set and the parameter gradients are all-reduced over it;
- ``sample``: each sample index marches a contiguous slice of every ray's
  samples, and the Beer-Lambert partials combine exactly
  (``parallel/sharding.py::render_partial``).

Launch one process per device with ``torchrun`` (``python -m
torch.distributed.run``); ``initialize_distributed`` joins its group. The
backend is NCCL for CUDA devices and gloo for the CPU. ``DeviceMesh``
creates a group for every row and column of the mesh, so every rank of the
world builds every mesh, in the same order, also the meshes it is not part
of (multi-granule runs build one mesh per granule).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from atmonr_tpu_torch.utils.device import resolve_device

AXES = ("data", "sample")


def initialize_distributed(device: str | torch.device | None = None) -> None:
    """Join the process group: from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) where it is set, else
    a world of this one process over an in-memory store. NCCL for a CUDA
    ``device`` (the default; this rank's card is then ``cuda:LOCAL_RANK``),
    gloo for the CPU. Does nothing when a group is already initialized."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for a CUDA ``device``
    without an index (``LOCAL_RANK`` is torchrun's, 0 when unset), else
    ``device`` itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(
    data: int | None = None, sample: int = 1, ranks: Sequence[int] | None = None
) -> DeviceMesh:
    """A (data, sample) mesh over ``ranks`` (all ranks of the world by
    default), data-major: rank ``ranks[d * sample + s]`` sits at (d, s).
    ``data=None`` puts every remaining rank on the data axis. Raises when
    the mesh needs more ranks than there are, naming the torchrun line."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: launch with torchrun and call "
            "initialize_distributed() first"
        )
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = len(ranks)
    if data is None:
        if n % sample:
            raise ValueError(f"{n} ranks do not divide into sample={sample}")
        data = n // sample
    if data < 1 or sample < 1:
        raise ValueError(f"mesh axes must be positive: data={data}, sample={sample}")
    if data * sample > n:
        raise ValueError(
            f"mesh data={data},sample={sample} needs {data * sample} ranks and there are "
            f"{n}: launch one process per device, e.g. torchrun --nproc-per-node "
            f"{data * sample} -m atmonr_tpu_torch.scripts.train --mesh data={data},"
            f"sample={sample} ..."
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = torch.tensor(ranks[: data * sample], dtype=torch.int64).reshape(data, sample)
    return DeviceMesh(device_type, layout, mesh_dim_names=AXES)


def parse_mesh_spec(spec: str) -> tuple[int | None, int]:
    """'data=N' / 'data=N,sample=M' / 'sample=M' -> (data or None, sample)."""
    axes: dict[str, int | None] = {"data": None, "sample": 1}
    for part in spec.split(","):
        k, v = part.split("=")
        k = k.strip()
        if k not in axes:
            raise ValueError(f"unknown mesh axis {k!r} (use data/sample)")
        axes[k] = int(v)
    return axes["data"], int(axes["sample"])


def make_mesh_from_spec(spec: str, ranks: Sequence[int] | None = None) -> DeviceMesh:
    """Parse 'data=N' / 'data=N,sample=M' into a mesh (``make_mesh``)."""
    data, sample = parse_mesh_spec(spec)
    return make_mesh(data=data, sample=sample, ranks=ranks)


class MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it: its group (None when the
    axis has one rank, which then needs no group traffic), its size and
    this rank's index along it."""

    group: dist.ProcessGroup | None
    size: int
    index: int


def mesh_axis(mesh: DeviceMesh | None, axis: str) -> MeshAxis:
    """``axis`` of ``mesh`` for this rank; a single-rank axis without a
    mesh."""
    if mesh is None:
        return MeshAxis(None, 1, 0)
    size = mesh_shape(mesh)[axis]
    index = mesh.get_local_rank(axis)
    return MeshAxis(mesh.get_group(axis) if size > 1 else None, size, index)


class MeshAxes(NamedTuple):
    """This rank's view of both axes of a mesh, taken once: ``DeviceMesh``'s
    accessors cost tens of microseconds each, and a train step needs the
    axes several times."""

    data: MeshAxis
    sample: MeshAxis


def mesh_axes(mesh: DeviceMesh) -> MeshAxes:
    return MeshAxes(mesh_axis(mesh, "data"), mesh_axis(mesh, "sample"))


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    # ``mesh.shape``, not ``mesh.mesh.shape``: the rank tensor is rebuilt on
    # every access (tens of us), and a step asks several times
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return mesh.get_coordinate() is not None


def is_first_rank(mesh: DeviceMesh | None) -> bool:
    """Whether this rank is the mesh's first, the one that logs and writes
    (every rank without a mesh, unless it is not rank 0 of a process
    group)."""
    if mesh is None:
        return not dist.is_initialized() or dist.get_rank() == 0
    return int(mesh.mesh.flatten()[0]) == dist.get_rank()


def mesh_barrier(mesh: DeviceMesh) -> None:
    """Wait until every rank of the mesh got here: a barrier over each
    data column, then over each sample row."""
    for axis in AXES:
        ax = mesh_axis(mesh, axis)
        if ax.group is not None:
            dist.barrier(group=ax.group)
