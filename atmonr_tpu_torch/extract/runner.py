"""Batched extinction-field query of a pipeline (counterpart of the JAX
package's ``extract/runner.py``): the points stream through
``pipeline.extract`` in fixed-size batches on the pipeline's device, and
the densities are rescaled to m^-1 by ``1/scale``. With a mesh, each of its
W ranks queries its contiguous 1/W of every batch and the ranks' sigma is
gathered at the end."""

from __future__ import annotations

import numpy as np
import torch

from atmonr_tpu_torch.utils import spans


@torch.no_grad()
def run_extraction(
    pipeline,
    points,
    batch_size: int = 32768,
    verbose: bool = False,
    mesh=None,
) -> np.ndarray:
    """Query ``pipeline.extract`` over ECEF points.

    ``points`` is an (N, 3) float64 array of ECEF coordinates in meters, or
    an object holding one as ``.xyz`` (an extraction grid). The points are
    normalized in float64 and cast to float32, as the JAX package does, and
    run in batches of ``batch_size`` and one shorter tail. ``verbose``
    prints the batch count as it goes. Returns sigma
    (N, num_density_outputs) in m^-1 as a float32 numpy array.

    ``mesh`` (every rank of it calls): the batch is trimmed to a multiple
    of the mesh's W ranks, as in the JAX package, and the rank at (d, s)
    queries rows [r m, (r + 1) m) of each batch, r = d * sample + s, m =
    1/W of the batch (the tail padded to a multiple of W); one gather at
    the end gives every rank the whole sigma. The points are independent,
    so with one rank the values equal the unsharded query's.
    """
    with spans.span("extract.query", cpu=True) as query:
        sigma = _query(pipeline, points, batch_size, verbose, mesh)
        query.count = len(sigma)
    return sigma


def _query(pipeline, points, batch_size: int, verbose: bool, mesh) -> np.ndarray:
    """The body of ``run_extraction``."""
    with spans.span("extract.normalize"):
        scale = pipeline.scale
        offset = np.asarray(pipeline.offset, np.float64)
        xyz = np.asarray(getattr(points, "xyz", points), np.float64)
        n = xyz.shape[0]
        pts_all = torch.from_numpy(((xyz - offset[None]) / scale).astype(np.float32))
    n_ranks, rank = 1, 0
    if mesh is not None:
        n_ranks = mesh.mesh.numel()
        coord = mesh.get_coordinate()
        rank = coord[0] * mesh.mesh.shape[1] + coord[1]
        batch_size = max(batch_size - batch_size % n_ranks, n_ranks)
    nb = -(-n // batch_size)
    with spans.span("extract.to_device", cpu=True):
        pts_all = pts_all.to(pipeline.device)

    out, shares = [], []
    for i in range(nb):
        with spans.span("extract.batch", count=min(batch_size, n - i * batch_size)):
            batch = pts_all[i * batch_size : (i + 1) * batch_size]
            if mesh is not None:
                m = -(-batch.shape[0] // n_ranks)
                shares.append(m)
                batch = batch[rank * m : (rank + 1) * m]
                if batch.shape[0] < m:  # the tail's last ranks: pad with the origin
                    batch = torch.cat([batch, batch.new_zeros((m - batch.shape[0], 3))])
            out.append(pipeline.extract(batch) / scale)
        if verbose:
            print(f"extract batch {i + 1}/{nb}", end="\r")
    if verbose:
        print()
    with spans.span("extract.to_host", cpu=True):
        sigma = torch.cat(out, dim=0)
        if mesh is not None:
            sigma = _gather_shares(sigma, shares, mesh)[:n]
        return sigma.cpu().numpy()


def _gather_shares(local: torch.Tensor, shares: list[int], mesh) -> torch.Tensor:
    """Every rank's shares of every batch, in batch order: rank r's share of
    batch i follows rank r-1's. A gather along "sample", then along
    "data"."""
    from atmonr_tpu_torch.parallel.mesh import mesh_axis
    from atmonr_tpu_torch.parallel.sharding import all_gather

    g = all_gather(local, mesh_axis(mesh, "sample"), False)  # (ns, L, k)
    g = all_gather(g, mesh_axis(mesh, "data"), False)  # (nd, ns, L, k)
    g = g.reshape(-1, *local.shape)  # (W, L, k)
    parts, offset = [], 0
    for m in shares:
        parts.append(g[:, offset : offset + m].reshape(-1, local.shape[1]))
        offset += m
    return torch.cat(parts, dim=0)
