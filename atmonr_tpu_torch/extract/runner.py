"""Batched extinction-field query of a pipeline (counterpart of the JAX
package's ``extract/runner.py``): the points stream through
``pipeline.extract`` in fixed-size batches on the pipeline's device, and
the densities are rescaled to m^-1 by ``1/scale``. With a mesh, each of its
W ranks queries its contiguous 1/W of every batch and the ranks' sigma is
gathered at the end.

The float64 ECEF points are normalized batch by batch on the pipeline's
device (``normalize``), never as a whole (N, 3) array: on a card a batch's
rows go through a ring of two pinned host buffers into one float64 batch
on the card, and the subtract, the divide and the round to float32 run
there, as the first operations of the batch's query.

On a card the full batches after the first replay one CUDA graph of the
batch's query, normalisation included: the host's Python and launches for
a batch take longer than the card's work on it, and a replay launches the
same kernels on the same shapes in one call. Each call captures its own
graph and drops it on return, so no graph outlives the parameters, buffers
and Python state it read. The query's device work runs on one stream of
the extraction's own (``_stream``), which copies the batches in, captures
and replays the graphs and runs the eager batches: cuBLAS keeps a
workspace for each stream that runs a GEMM (32 MiB on an H100), so eager
batches on a second stream would hold a second one."""

from __future__ import annotations

import dataclasses
import functools
from contextlib import contextmanager

import numpy as np
import torch

from atmonr_tpu_torch.models.hash_grid import hash_encode_exact
from atmonr_tpu_torch.ops.hash_gather import (
    hash_gather,
    prepare_table,
    quantize_tables,
    round_table_bf16,
)
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
    an object holding one as ``.xyz`` (an extraction grid). They run in
    batches of ``batch_size`` and one shorter tail, each normalized in
    float64 and cast to float32 on the pipeline's device, as the JAX
    package does on the host (bit for bit), and written into its rows of
    one sigma on the device. ``verbose`` prints the batch count as it goes.
    Returns sigma (N, num_density_outputs) in m^-1 as a float32 numpy
    array.

    On a CUDA device each batch's rows are copied into the next of two
    pinned host buffers (``_ring``) and from there into one float64 batch
    on the card; the host waits only before it refills a buffer whose copy
    has not left it. Where there are two full batches or more, the first
    runs eagerly as the warm-up of a capture of the batch's query
    (``pipeline.extract`` of the normalized batch, over ``scale``) at the
    full batch's rows, and every later full batch replays that graph; the
    graph is dropped on return. The tail, a lone full batch, and every
    batch on the CPU run eagerly; on the CPU a batch is normalized from a
    view of its rows. The graph launches the same kernels on the same
    shapes, so sigma is the eager query's. Counters:
    ``run_extraction.graph_batches``, ``.eager_batches`` (warm-ups
    included), ``.captures`` and ``.staged_batches`` (the batches that went
    through the pinned ring: on a card all of them, on the CPU none); a
    replay adds the K1 and K1p launches of its graph to
    ``hash_gather.launches``, ``quantize_tables.launches`` and
    ``round_table_bf16.launches``, its table preparations to
    ``prepare_table.calls`` and its exact gathers to
    ``hash_encode_exact.calls``; a capture adds none.

    ``mesh`` (every rank of it calls): the batch is trimmed to a multiple
    of the mesh's W ranks, as in the JAX package, and the rank at (d, s)
    queries rows [r m, (r + 1) m) of each batch, r = d * sample + s, m =
    1/W of the batch (the tail padded with zero rows, after the
    normalisation, to a multiple of W); only those rows are staged. One
    gather at the end gives every rank the whole sigma. The points are
    independent, so with one rank the values equal the unsharded query's.
    """
    with spans.span("extract.query", cpu=True) as query:
        sigma = _query(pipeline, points, batch_size, verbose, mesh)
        query.count = len(sigma)
    return sigma


run_extraction.graph_batches = 0
run_extraction.eager_batches = 0
run_extraction.captures = 0
run_extraction.staged_batches = 0


def _query(pipeline, points, batch_size: int, verbose: bool, mesh) -> np.ndarray:
    """The body of ``run_extraction``."""
    scale = pipeline.scale
    xyz = np.asarray(getattr(points, "xyz", points), np.float64)
    n = xyz.shape[0]
    n_ranks, rank = 1, 0
    if mesh is not None:
        n_ranks = mesh.mesh.numel()
        coord = mesh.get_coordinate()
        rank = coord[0] * mesh.mesh.shape[1] + coord[1]
        batch_size = max(batch_size - batch_size % n_ranks, n_ranks)
    sizes = [min(batch_size, n - lo) for lo in range(0, n, batch_size)]
    shares = [-(-size // n_ranks) for size in sizes]  # this rank's rows of each batch
    device = torch.device(pipeline.device)
    with _own_stream(device):
        # the normalisation's operands as float64 tensors on the device: on a
        # card, division by a CPU scalar multiplies by its reciprocal
        offset = torch.as_tensor(np.asarray(pipeline.offset, np.float64), device=device)
        coord_scale = torch.tensor(float(scale), dtype=torch.float64, device=device)

        def query(x64: torch.Tensor, pad: int = 0) -> torch.Tensor:
            return pipeline.extract(normalize(x64, offset, coord_scale, pad)) / scale

        staged = None
        if device.type == "cuda":  # one float64 batch on the card, fed from a pinned ring
            staged = torch.empty((shares[0], 3), dtype=torch.float64, device=device)
            ring = _ring(torch.cuda.current_stream().device_index, batch_size // n_ranks)
        graphed = staged is not None and sizes.count(batch_size) > 1
        captured, sigma, row = None, None, 0
        for i, (size, m) in enumerate(zip(sizes, shares)):
            with spans.span("extract.batch", count=size):
                lo = min(i * batch_size + rank * m, i * batch_size + size)
                hi = min(lo + m, i * batch_size + size)
                with spans.span("extract.to_device", count=hi - lo):
                    if staged is None:
                        x64 = torch.from_numpy(np.ascontiguousarray(xyz[lo:hi]))
                    else:
                        x64 = ring.stage(xyz[lo:hi], staged[: hi - lo])
                        run_extraction.staged_batches += 1
                if not (graphed and size == batch_size):
                    out = query(x64, m - (hi - lo))  # the tail's last ranks: pad with the origin
                    run_extraction.eager_batches += 1
                elif captured is None:
                    with spans.span("extract.capture", count=m):
                        captured, out = _capture(query, x64)
                    run_extraction.captures += 1
                    run_extraction.eager_batches += 1
                else:
                    out = captured.replay()
                    run_extraction.graph_batches += 1
                if sigma is None:
                    sigma = out.new_empty((sum(shares), out.shape[1]))
                sigma[row : row + m].copy_(out)
                row += m
            if verbose:
                print(f"extract batch {i + 1}/{len(sizes)}", end="\r")
        if verbose:
            print()
        with spans.span("extract.to_host", cpu=True):
            if mesh is not None:
                sigma = _gather_shares(sigma, shares, mesh)[:n]
            return sigma.cpu().numpy()


def normalize(x64: torch.Tensor, offset: torch.Tensor, scale: torch.Tensor,
              pad: int = 0) -> torch.Tensor:
    """ECEF points (M, 3) float64 -> normalized scene points (M + pad, 3)
    float32, ``pad`` rows of zeros (the origin) after them: the float64
    subtract and divide and the round to float32 are the IEEE operations
    of the JAX package's host normalisation, so the points equal it bit
    for bit. ``offset`` (3,) and ``scale`` () are float64 tensors on the
    points' device."""
    pts = ((x64 - offset) / scale).float()
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
    return pts


class _PinnedRing:
    """Two pinned float64 host buffers of ``rows`` x 3, filled in turn: a
    batch's rows go into the next slot and leave it in one copy to the
    card on the current stream; the slot is filled again only once that
    copy is done (its event), the one wait of the host on the card."""

    def __init__(self, rows: int):
        self.slots = [torch.empty((rows, 3), dtype=torch.float64, pin_memory=True)
                      for _ in range(2)]
        self.views = [slot.numpy() for slot in self.slots]
        self.events = [torch.cuda.Event() for _ in range(2)]
        self.next = 0

    def stage(self, rows: np.ndarray, dst: torch.Tensor) -> torch.Tensor:
        """``rows`` (M, 3) into ``dst`` on the card; returns ``dst``."""
        k, self.next = self.next, 1 - self.next
        self.events[k].synchronize()  # the slot's last copy has left it
        np.copyto(self.views[k][: len(rows)], rows)
        dst.copy_(self.slots[k][: len(rows)], non_blocking=True)
        self.events[k].record()
        return dst


@functools.cache
def _ring(index: int, rows: int) -> _PinnedRing:
    """The extraction's staging ring on card ``index`` for a rank's share
    of ``rows`` points of a full batch, one for the process."""
    return _PinnedRing(rows)


@contextmanager
def _own_stream(device):
    """On a card, the block on ``_stream``, after the work already queued
    on the current stream and before the work queued on it later; on the
    CPU, nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    current = torch.cuda.current_stream(device)
    stream = _stream(current.device_index)
    stream.wait_stream(current)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        current.wait_stream(stream)


@functools.cache
def _stream(index: int) -> torch.cuda.Stream:
    """The extraction's stream on card ``index``, one for the process."""
    return torch.cuda.Stream(index)


@dataclasses.dataclass
class _CapturedQuery:
    """One CUDA graph of the batch's query at a static input and output.
    ``increments`` are the counter increments of one replay: (counter, its
    key, increment). A replay reads the static input as it stands and its
    result is valid until the next replay."""

    graph: torch.cuda.CUDAGraph
    static_out: torch.Tensor
    increments: list

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for counter, k, v in self.increments:
            counter[k] += v
        return self.static_out


def _capture(query, static_in: torch.Tensor) -> tuple[_CapturedQuery, torch.Tensor]:
    """The documented pattern, on the current stream, which ``_own_stream``
    made a side stream: a warm-up of ``query`` on ``static_in``, whose sigma
    it returns beside the graph, then the capture, which reads
    ``static_in`` at every replay."""
    out = query(static_in)  # lazy set-up (libraries, handles) before capture
    # what the query's graph moves: K1's and K1p's launches, the table
    # preparations, the exact gathers
    counters = (hash_gather.launches, quantize_tables.launches, round_table_bf16.launches,
                prepare_table.calls, hash_encode_exact.calls)
    before = [dict(c) for c in counters]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.current_stream(static_in.device),
                          capture_error_mode="thread_local"):
        static_out = query(static_in)
    increments = []
    for counter, was in zip(counters, before):  # a capture launches nothing; each replay does
        increments += [(counter, k, v - was[k]) for k, v in counter.items() if v != was[k]]
        counter.update(was)
    return _CapturedQuery(graph, static_out, increments), out


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
