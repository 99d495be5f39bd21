"""The multi-device train step: rays data-parallel, samples sample-parallel.
The counterpart of the JAX package's ``parallel/train.py``.

- Each data index trains on its own rows of the batch with the unmodified
  pipeline (``forward_loss_data_sharded``); the hash kernels see the
  rank's own shapes.
- With a sample axis, each sample index computes the whole z values of its
  rows and marches its contiguous slice of them; the slices' Beer-Lambert
  partials combine exactly (``sharding.render_partial``), and every rank
  computes the surface branch (``ngp_forward_sample_sharded``).
The functions called on every step take the rank's view of the mesh,
``MeshAxes`` (``mesh.mesh_axes(mesh)``, taken once), not the ``DeviceMesh``.

- After the backward, ``reduce_gradients`` makes every rank's gradient the
  same: the volume branch's (``pos_table``, ``pos_mlp``, ``dir_mlp``)
  summed over "sample", for each rank computed it on its own samples; the
  surface branch's, computed identically by every sample rank, left alone;
  then everything summed over "data", where each rank's loss was its share
  (divided by the data size), in one ``all_reduce`` of a flat buffer per
  axis of more than one rank, which carries the loss too.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from atmonr_tpu_torch.data import batching
from atmonr_tpu_torch.models.encoders import apply_composite
from atmonr_tpu_torch.ops import occupancy
from atmonr_tpu_torch.ops.samplers import sample_piecewise, sample_uniform_bins
from atmonr_tpu_torch.parallel.mesh import MeshAxes, mesh_axes
from atmonr_tpu_torch.parallel.sharding import psum, render_partial

# the parameters of the volume branch, whose gradients the sample ranks sum
VOLUME_PARAMETERS = ("pos_table", "pos_mlp", "dir_mlp")


def is_volume_parameter(name: str) -> bool:
    return name.split(".")[0] in VOLUME_PARAMETERS


def sample_sharded_samples(pipe) -> int:
    """Samples per ray of the sample-sharded forward: the occupancy grid's
    ``n_fine``, else ``num_samples_per_ray`` (also for an importance
    config, which this forward samples uniformly)."""
    if pipe.occ_cfg is not None:
        return int(pipe.occ_cfg.n_fine)
    return int(pipe.config["num_samples_per_ray"])


def sample_sharded_draws(
    pipe, batch_size: int, generator: torch.Generator
) -> dict[str, torch.Tensor]:
    """The random draws of one sample-sharded forward, from ``generator``:
    the occupancy sampler's ``probe`` and ``fine``, else the uniform
    sampler's ``bins`` ((B, num_samples_per_ray)); no rounding noise."""
    dev = pipe.device

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=generator.device).to(dev)

    if pipe.occ_cfg is not None:
        oc = pipe.occ_cfg
        return {
            "probe": uniform((batch_size, oc.n_probe)),
            "fine": uniform((batch_size, oc.n_fine)) * (1.0 / oc.n_fine),
        }
    return {"bins": uniform((batch_size, sample_sharded_samples(pipe)))}


def ngp_forward_sample_sharded(
    pipe,
    ray_batch: Mapping[str, torch.Tensor],
    axes: MeshAxes,
    draws: Mapping[str, torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """Instant-NGP forward of this rank's rays with the samples split over
    the mesh's "sample" axis, as the JAX package's ``ngp_forward_sample_sharded``
    computes it, which differs from its single-device forward (and from
    ``InstantNGPPipeline.forward``) in four ways:

    - no stochastic-rounding noise in the position encoding;
    - ``relu`` for sigma, also under ``density_activation: "softplus"``;
    - the uniform sampler for an importance config;
    - 3-D points only (no ``include_height``).

    Sample placement (occupancy-grid piecewise CDF when the pipeline has a
    grid, else uniform bins; ``draws`` from ``sample_sharded_draws``, the
    midpoints without) is computed whole on every sample rank, which then
    marches its contiguous slice. Differentiable in the parameters; the
    collectives' gradients are ``sharding.py``'s. Returns the color maps
    and surface color of the rays (the same on every sample rank) and this
    rank's slice of the weights.
    """
    if pipe.num_inputs != 3:
        raise ValueError("the sample-sharded forward takes 3-D points (no include_height)")
    ax = axes.sample
    draws = draws or {}
    num_bands = pipe.config["num_bands"]
    nd = pipe.num_density_outputs
    scale_km = pipe.scale / 1000.0

    with torch.no_grad():
        if pipe.occ_cfg is not None:
            oc = pipe.occ_cfg
            pts_p, _ = sample_uniform_bins(ray_batch, oc.n_probe, draws.get("probe"))
            w = occupancy.probe_weights(pipe.occ, pipe._unit_coords(pts_p), oc)
            _, z_vals = sample_piecewise(ray_batch, w, oc.n_fine, draws.get("fine"))
        else:
            _, z_vals = sample_uniform_bins(
                ray_batch, sample_sharded_samples(pipe), draws.get("bins")
            )
    n = z_vals.shape[1]
    if n % ax.size:
        raise ValueError(f"{n} samples per ray do not split over {ax.size} sample ranks")
    n_loc = n // ax.size
    z = z_vals[:, ax.index * n_loc : (ax.index + 1) * n_loc]

    origin, direction = ray_batch["origin"], ray_batch["dir"]
    b = origin.shape[0]
    pts = origin[:, None] + direction[:, None] * z[..., None]
    if pipe.point_preprocessor:
        pts = pipe.point_preprocessor(pts)
    pts = (pts + 1.0) / 2.0
    alt_c = pts[..., 2] / pipe.config["alt_compress_factor"]
    pts = torch.cat([pts[..., :2], alt_c[..., None]], dim=-1)

    pos_out = pipe._pos_branch(torch.reshape(pts, (b * n_loc, -1)))
    dirs = direction[:, None].expand(b, n_loc, 3)
    dir_in = torch.cat([torch.reshape(dirs, (b * n_loc, 3)), pos_out[:, nd:]], dim=1)
    dir_enc = apply_composite({}, pipe.dir_specs, dir_in)
    color = pipe.dir_mlp(dir_enc, compute_dtype=pipe.compute_dtype)
    color = torch.relu(torch.reshape(color, (b, n_loc, num_bands)))
    sigma = torch.relu(torch.reshape(pos_out[..., :nd], (b, n_loc, -1)))
    color_map_atmo, trans_total, _, weights = render_partial(z * scale_km, color, sigma, ax)

    # surface branch: per ray, on every sample rank
    pts_surf = origin + direction * ray_batch["len"][:, None]
    pts_surf = (pts_surf + 1.0) / 2.0
    surf_in = torch.cat([pts_surf[:, :2], direction], dim=1)
    surf_enc = apply_composite(pipe._surf_tables(), pipe.surf_specs, surf_in)
    color_surf = torch.relu(pipe.surf_mlp(surf_enc, compute_dtype=pipe.compute_dtype))

    color_map_surf = trans_total * color_surf
    return {
        "color_map_fine": color_map_atmo + color_map_surf,
        "color_map_atmo": color_map_atmo,
        "color_map_surf": color_map_surf,
        "color_surf": color_surf,
        "weights_fine": weights,
    }


def forward_loss_data_sharded(
    pipe,
    ray_batch: Mapping[str, torch.Tensor],
    axes: MeshAxes,
    draws: Mapping[str, torch.Tensor] | None = None,
):
    """Forward and loss of this rank's rows of the batch with the
    unmodified pipeline (any pipeline: Instant-NGP or NeRF); the loss is
    the mean over "data" of the ranks' losses (equal row counts), the same
    on every rank and differentiable (its cotangent passes through the
    ``psum``). The parameter gradients are then this rank's share: sum
    them over "data" with ``reduce_gradients``. Returns ``(loss,
    results)``, the results of this rank's rows. (The Trainer sums the
    loss's shares in ``reduce_gradients``' buffer instead, so that a step
    has one collective.)"""
    ax = axes.data
    results = pipe(ray_batch, draws=draws)
    loss = psum(pipe.compute_loss(ray_batch, results) / ax.size, ax)
    return loss, results


@torch.no_grad()
def reduce_gradients(
    named_params: Sequence[tuple[str, torch.nn.Parameter]],
    axes: MeshAxes,
    loss: torch.Tensor | None = None,
) -> torch.Tensor | None:
    """Make every rank's ``.grad`` the mesh's gradient, in place: the volume
    branch's gradients summed over "sample", then every gradient summed over
    "data". Each rank's gradient must be its share, the gradient of its loss
    divided by the data size, as ``forward_loss_data_sharded``'s backward
    gives it. One ``all_reduce`` of one flat buffer for each axis that has
    more than one rank (an axis of one rank moves nothing and is skipped).
    ``loss``, this rank's share of the loss, rides in the data buffer;
    returns its sum over "data" (None without it)."""
    data, sample = axes
    if data.group is None and sample.group is None:
        return loss
    vol = [p for n, p in named_params if is_volume_parameter(n)]
    order = vol + [p for n, p in named_params if not is_volume_parameter(n)]
    for p in order:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in order]
    pieces = [g.reshape(-1) for g in grads]
    if loss is not None:
        pieces.append(loss.detach().reshape(1).to(pieces[0].dtype))
    flat = torch.cat(pieces)
    n_vol = sum(p.numel() for p in vol)
    if sample.group is not None and n_vol:
        dist.all_reduce(flat[:n_vol], group=sample.group)
    if data.group is not None:
        dist.all_reduce(flat, group=data.group)
    views = flat.split([g.numel() for g in grads] + ([1] if loss is not None else []))
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(views, grads)])
    # a copy: a view would keep the whole flat buffer alive with the loss
    return views[-1].reshape(()).clone() if loss is not None else None


def make_ngp_sharded_train_step(pipe, optimizer, mesh: DeviceMesh, batch_size: int):
    """A train step on this rank's rows: gather -> sample-sharded forward
    -> loss -> backward -> ``reduce_gradients`` -> ``optimizer.step()``.
    ``step(rays, perm, step_in_epoch, draws=None)`` returns the loss's mean
    over "data"; ``batch_size`` is the rank's rows per step. Refresh the
    occupancy grid on the host's cadence with ``pipe.update_aux``."""
    named = list(pipe.named_parameters())
    axes = mesh_axes(mesh)

    def step(rays, perm, step_in_epoch: int, draws=None) -> torch.Tensor:
        batch = batching.batch_at_step(rays, perm, step_in_epoch, batch_size)
        optimizer.zero_grad()
        results = ngp_forward_sample_sharded(pipe, batch, axes, draws)
        loss = pipe.compute_loss(batch, results) / axes.data.size
        loss.backward()
        loss = reduce_gradients(named, axes, loss)
        optimizer.step()
        return loss

    return step
