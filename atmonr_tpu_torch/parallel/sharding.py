"""Ray sharding, replication, the collectives with their gradients, and the
sample-axis compositor: the counterpart of the JAX package's
``parallel/sharding.py``.

The data axis holds rays: each data index keeps its own contiguous rows
(``shard_rays``), parameters are the same on every rank (``replicate``) and
their gradients are all-reduced (``parallel/train.py::reduce_gradients``).

The sample axis splits each ray's samples into contiguous slices. The
compositor's transmittance factorizes over them, so each slice composites
locally and the slices combine exactly through three collectives:

    weights_i = alpha_i * prod_{j<i}(1 - alpha_j + eps)
             = alpha_i * [prod over earlier slices of their totals] * C_local

Voronoi deltas at a slice's ends need the neighbours' boundary z (the ring
exchange of JAX's ``ppermute``; here an ``all_gather`` of each slice's two
boundary values, on NCCL and gloo alike), the slices' totals are combined by
an ``all_gather`` and a masked product, and the color by a ``psum``.

JAX derives the gradients of these collectives from ``shard_map``'s
transpose; here each is an ``autograd.Function`` with its rule written out.
Every rank of the sample group computes the same loss, so:

- a collective whose output every rank consumes identically (the color
  ``psum``; the ``all_gather`` of the totals for ``trans_total``) passes its
  cotangent through: the identity for ``psum``, this rank's own slot for
  ``all_gather``, with nothing summed;
- an ``all_gather`` whose slots each rank consumes differently (the masked
  prefix, the neighbours' boundary z) sums the slot's cotangents over the
  ranks: a reduce-scatter (on gloo, which has none, an ``all_reduce`` and
  this rank's slot).

Every rank must run the backward of every collective, in the same order:
a rank that does not use a slot still keeps it in the graph (the masked
product multiplies by 1 rather than dropping it).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from atmonr_tpu_torch.parallel.mesh import MeshAxis, mesh_axis


# the single-tensor collectives (renamed in newer torch releases)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (
    getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: MeshAxis, sum_backward: bool) -> torch.Tensor:
        ctx.axis, ctx.sum_backward = axis, sum_backward
        out = torch.empty(axis.size * x.numel(), dtype=x.dtype, device=x.device)
        _all_gather_single(out, x.contiguous().reshape(-1), group=axis.group)
        return out.view(axis.size, *x.shape)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        axis = ctx.axis
        if not ctx.sum_backward:
            return g[axis.index], None, None
        if dist.get_backend(axis.group) == "gloo":
            g = g.contiguous().clone()
            dist.all_reduce(g, group=axis.group)
            return g[axis.index], None, None
        out = torch.empty(g[0].numel(), dtype=g.dtype, device=g.device)
        _reduce_scatter_single(out, g.contiguous().reshape(-1), group=axis.group)
        return out.view(g.shape[1:]), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def all_gather(x: torch.Tensor, axis: MeshAxis, sum_backward: bool) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` along ``axis``, differentiable.
    ``sum_backward`` says whether the ranks consume the slots differently
    (the cotangents are then summed over the ranks) or identically (each
    rank takes its own slot's)."""
    if axis.size == 1:
        return x[None]
    return _AllGather.apply(x, axis, sum_backward)


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, for a consumer that every rank
    runs identically (the cotangent passes through)."""
    if axis.size == 1:
        return x
    return _Psum.apply(x, axis)


# -- placement -----------------------------------------------------------------------


def shard_rays(
    rays: Mapping[str, torch.Tensor], mesh: DeviceMesh, axis: str = "data"
) -> dict[str, torch.Tensor]:
    """This rank's rows of the ray tensors: the ray count trimmed to a
    multiple of the ``axis`` size (the remainder is fewer rays than the
    axis has ranks), then the contiguous block of this rank's index
    (``parallel/data.py::host_ray_slice``). Ranks along the other axis hold
    the same rows."""
    from atmonr_tpu_torch.parallel.data import host_ray_slice

    n_total = next(iter(rays.values())).shape[0]
    sl = host_ray_slice(n_total, mesh, axis)
    return {k: v[sl] for k, v in rays.items()}


@torch.no_grad()
def replicate(tensors, mesh: DeviceMesh) -> None:
    """Overwrite each tensor, in place, with the mesh's first rank's: a
    broadcast down each data column from its first row, then along each
    sample row from its first column. ``tensors`` is an iterable of tensors
    or an ``nn.Module`` (its parameters and buffers, the occupancy grid
    among them). Every rank of the mesh calls it with the same tensors."""
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.state_dict().values())
    tensors = list(tensors)
    layout = mesh.mesh
    for name in ("data", "sample"):
        ax = mesh_axis(mesh, name)
        if ax.group is None:
            continue
        coord = mesh.get_coordinate()
        src = int(layout[0, coord[1]] if name == "data" else layout[coord[0], 0])
        for t in tensors:
            dist.broadcast(t, src=src, group=ax.group)


# -- the sample-axis compositor --------------------------------------------------------


def render_partial(
    z_local: torch.Tensor,
    color_local: torch.Tensor,
    sigma_local: torch.Tensor,
    axis: MeshAxis,
):
    """Beer-Lambert compositing of this rank's slice of the samples, combined
    exactly with the other slices along ``axis``.

    Args (this rank's slice of the sample axis):
        z_local: (B, n_loc) sample distances (km), sorted along the whole
            ray, slice s holding samples [s * n_loc, (s + 1) * n_loc).
        color_local: (B, n_loc, C). sigma_local: (B, n_loc, 1 or C).

    Returns:
        color_map: (B, C) composited color, the same on every rank.
        trans_total: (B, C) total volume transmittance prod(1 - alpha), with
            no epsilon guard (the surface term's factor), the same on every
            rank.
        alpha_local: (B, n_loc, C). weights_local: (B, n_loc, 1 or C).
    """
    s, ns = axis.index, axis.size
    z_local = z_local.to(color_local.dtype)
    z_first, z_last = z_local[:, 0], z_local[:, -1]

    # Voronoi edges need the neighbours' boundary z: each slice's first and
    # last value, gathered
    e_left, e_right = torch.zeros_like(z_first), z_last
    if ns > 1:
        ends = all_gather(torch.stack([z_first, z_last], dim=-1), axis, sum_backward=True)
        if s > 0:
            e_left = (ends[s - 1, :, 1] + z_first) / 2.0
        if s < ns - 1:
            e_right = (z_last + ends[s + 1, :, 0]) / 2.0
    e_inner = (z_local[:, :-1] + z_local[:, 1:]) / 2.0
    edges = torch.cat([e_left[:, None], e_inner, e_right[:, None]], dim=-1)
    delta = torch.diff(edges, dim=-1)[..., None]

    alpha = 1.0 - torch.exp(-sigma_local * delta)
    guarded = 1.0 - alpha + 1e-10

    # within-slice exclusive cumulative transmittance
    ones = torch.ones(
        (alpha.shape[0], 1, alpha.shape[2]), dtype=alpha.dtype, device=alpha.device
    )
    c_local = torch.cumprod(torch.cat([ones, guarded], dim=1), dim=1)[:, :-1]

    # cross-slice prefix: the product of the earlier slices' totals
    t_all = all_gather(torch.prod(guarded, dim=1), axis, sum_backward=True)  # (ns, B, C)
    earlier = (torch.arange(ns, device=alpha.device) < s)[:, None, None]
    prefix = torch.prod(torch.where(earlier, t_all, torch.ones_like(t_all)), dim=0)

    weights = alpha * prefix[:, None, :] * c_local
    color_map = psum(torch.sum(color_local * weights, dim=1), axis)

    # total transmittance for the opaque-surface term (no epsilon guard)
    t2_all = all_gather(torch.prod(1.0 - alpha, dim=1), axis, sum_backward=False)
    trans_total = torch.prod(t2_all, dim=0)
    return color_map, trans_total, alpha, weights


def render_sample_sharded(
    z_vals: torch.Tensor,
    color: torch.Tensor,
    sigma: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "sample",
):
    """``ops.compositor.render`` over whole (B, N, C) rays with the samples
    split over ``mesh[axis]``: this rank composites its contiguous slice
    through ``render_partial``. Returns (color_map, trans_total) of the
    whole rays and this rank's slices of alpha and the weights."""
    ax = mesh_axis(mesh, axis)
    n = z_vals.shape[1]
    if n % ax.size:
        raise ValueError(f"{n} samples per ray do not split over {ax.size} ranks")
    n_loc = n // ax.size
    sl = slice(ax.index * n_loc, (ax.index + 1) * n_loc)
    return render_partial(z_vals[:, sl], color[:, sl], sigma[:, sl], ax)
