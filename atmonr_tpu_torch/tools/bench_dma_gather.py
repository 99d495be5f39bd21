"""Random-row gather bandwidth on the card: the counterpart of the JAX
repo's ``tools/bench_dma_gather.py``.

A table of 2 float32 features an entry, read at random rows, three ways:

1. **Gather** (``index_select``), f32 and bf16 rows, random and sorted
   indices, N = 2^20 lookups a call.
2. **Row width**: the same table viewed as rows of g in (2, 8, 32, 64)
   entries, N random rows a call (g = 64 is a 512-byte f32 row).
3. **Block fetch** (kernel T2, ``ops/block_fetch.py``): 2^17 tile rows of
   512 bytes a call (64 MiB in, 64 MiB out) in random runs of ``rpd`` in
   (1, 4, 32) consecutive rows, 256 runs a block. Each point is first held
   to its plain version with ``torch.equal``, and a wrong result raises.
   On a card it also gets its device time by CUDA-graph replay, its rate in
   GB/s (bytes read plus written over that time), the plain version's time
   a call and ``index_select`` of the same rows as the library's time. Its
   bound is those bytes over HBM's 3.35 TB/s for a table beyond the L2; a
   table that fits the L2 has none (NVIDIA publishes no L2 rate).

The table holds 2^21 entries by default (16 MiB: it fits the H100's 50 MB
L2, so these rates are the L2's); ``--tile-rows 330339`` gives the
21,141,696 entries of ``configs/instant_ngp_occ21.json`` (169 MB, beyond
the L2). Every line names its table's size.

Timing (the JAX tool's ``_rate``): warm calls, then a window of calls with
one sync at its end; units a second and ms a call.

    python -m atmonr_tpu_torch.tools.bench_dma_gather [--tile-rows N]

The last line is one JSON object: ``table_rows``, ``n_lookups``,
``tile_row_bytes``, ``results`` (and ``device``).
"""

from __future__ import annotations

import argparse
import json

import torch

from atmonr_tpu_torch.ops import block_fetch as bfo
from atmonr_tpu_torch.utils.device import resolve_device
from atmonr_tpu_torch.utils.timing import graph_ms, median_ms, wall_s

LANES = bfo.ROW_FLOATS
FEATURES = 2
TILE_ROWS = (1 << 21) * FEATURES // LANES  # 2^21 entries
TILE_ROWS_OCC21 = 330_339  # 21,141,696 entries: configs/instant_ngp_occ21.json
N_LOOKUPS = 1 << 20
FETCHED_TILE_ROWS = 1 << 17  # 64 MiB fetched a call
ROWS_PER_DESC = (1, 4, 32)
ROW_GROUPS = (2, 8, 32, 64)
PEAK_BYTES_S = 3.35e12  # H100 SXM, NVIDIA data sheet, at 700 W
L2_BYTES = 50e6


def rate(fn, per_call: float, device: torch.device, warm: int = 60,
         iters: int = 50) -> tuple[float, float]:
    """(units/s, ms/call): ``warm`` calls, then ``iters`` calls timed with
    one sync at the end."""
    sec = wall_s(fn, device, iters, warm)
    return per_call / sec, sec * 1e3


def fetch_bytes(n_desc: int, rpd: int) -> int:
    """Bytes the block fetch must move: each fetched row read once and
    written once, and the indices read once."""
    return 2 * n_desc * rpd * LANES * 4 + n_desc * 4


def fetch_bound(tile_rows: int, n_desc: int, rpd: int) -> tuple[float | None, str]:
    """(ms, what bounds it): ``fetch_bytes`` over HBM's rate for a table
    beyond the L2. For a table that fits the L2 the rows are read from it,
    at a rate with no published peak, so there is no bound (None)."""
    if tile_rows * LANES * 4 < L2_BYTES:
        return None, "none: the table fits the 50 MB L2, which has no published rate"
    return 1e3 * fetch_bytes(n_desc, rpd) / PEAK_BYTES_S, "bytes"


def fetch_indices(tile_rows: int, n_desc: int, rpd: int, gen: torch.Generator) -> torch.Tensor:
    """(n_desc,) int32 run starts in [0, tile_rows - rpd): every run lies
    in the table by construction."""
    return torch.randint(0, tile_rows - rpd, (n_desc,), generator=gen, device=gen.device,
                         dtype=torch.int32)


def check_block_fetch(tiles: torch.Tensor, idx: torch.Tensor, rpd: int) -> float:
    """Raises unless the kernel's rows (the plain version's on the CPU)
    equal the plain version's; returns their largest absolute difference."""
    got = bfo.block_fetch(tiles, idx, rpd)
    want = bfo.block_fetch_plain(tiles, idx, rpd)
    if not torch.equal(got, want):
        bad = int((got != want).any(dim=1).sum())
        raise RuntimeError(f"block fetch rpd={rpd} differs from its plain version in {bad} rows")
    return float((got - want).abs().max())


def main(argv: list[str] | None = None, *, device: str | torch.device | None = None,
         n_lookups: int = N_LOOKUPS, fetched_tile_rows: int = FETCHED_TILE_ROWS,
         warm: int = 60, iters: int = 50, fetch_warm: int = 30,
         fetch_iters: int = 30) -> dict:
    """Runs the three curves; prints a line a point and the JSON line last,
    and returns its object. ``device`` is ``cuda`` unless given."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tile-rows", type=int, default=TILE_ROWS,
                        help=f"512-byte rows of the table (default {TILE_ROWS}: 2^21 entries; "
                             f"{TILE_ROWS_OCC21}: configs/instant_ngp_occ21.json's 2^21 table)")
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    tile_rows = args.tile_rows
    t = tile_rows * LANES // FEATURES  # table entries
    n = n_lookups
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((t, FEATURES), generator=gen, device=dev)
    idx = torch.randint(0, t, (n,), generator=gen, device=dev, dtype=torch.int32)
    table_bytes = table.numel() * 4
    where = "fits" if table_bytes < L2_BYTES else "exceeds"
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tag = f"[{table_bytes / 1e6:.1f} MB table]"
    print(f"{tag} {t} entries x {FEATURES} f32 = {table_bytes / 1e6:.1f} MB ({where} the "
          f"H100's 50 MB L2), {tile_rows} rows of {LANES * 4} B, on {name}", flush=True)
    results = []

    def record(label, r, ms, unit="rows", **extra):
        results.append({"name": label, f"{unit}_per_s": r, "ms": ms, **extra})
        more = "".join(f", {k} {v:.4f}" if isinstance(v, float) else f", {k} {v}"
                       for k, v in extra.items())
        print(f"{tag} {label:34s} {r / 1e6:9.2f} M {unit}/s  ({ms:.3f} ms{more})", flush=True)

    def take(tbl, ix):
        return lambda: torch.index_select(tbl, 0, ix)

    record("index_select_f32", *rate(take(table, idx), n, dev, warm, iters))
    table_bf16 = table.to(torch.bfloat16)
    record("index_select_bf16", *rate(take(table_bf16, idx), n, dev, warm, iters))
    record("index_select_f32_sorted", *rate(take(table, torch.sort(idx)[0]), n, dev, warm, iters))
    del table_bf16

    # rows/s against row width: the same bytes in wider rows, fewer of them
    for g in ROW_GROUPS:
        tg = table.reshape(t // g, g * FEATURES)
        ig = torch.randint(0, t // g, (n,), generator=gen, device=dev, dtype=torch.int32)
        record(f"index_select_f32_row{g * FEATURES * 4}B", *rate(take(tg, ig), n, dev, warm, iters))
        tg16 = tg.to(torch.bfloat16)
        record(f"index_select_bf16_row{g * FEATURES * 2}B",
               *rate(take(tg16, ig), n, dev, warm, iters))
        del tg16

    # the block-fetch curve over the table's 512-byte tile rows
    tiles = table.reshape(tile_rows, LANES)
    for rpd in ROWS_PER_DESC:
        n_desc = fetched_tile_rows // rpd
        idx_t = fetch_indices(tile_rows, n_desc, rpd, gen)
        err = check_block_fetch(tiles, idx_t, rpd)
        r, ms = rate(lambda: bfo.block_fetch(tiles, idx_t, rpd), n_desc, dev, fetch_warm,
                     fetch_iters)
        bound_ms, bound_by = fetch_bound(tile_rows, n_desc, rpd)
        extra = {"equal": True, "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by}
        if dev.type == "cuda":
            dev_ms = graph_ms(lambda: bfo.block_fetch(tiles, idx_t, rpd))
            rows = bfo.expanded_rows(idx_t, rpd)
            extra.update(
                device_ms=dev_ms,
                gb_per_s=fetch_bytes(n_desc, rpd) / dev_ms / 1e6,
                plain_ms=median_ms(lambda: bfo.block_fetch_plain(tiles, idx_t, rpd), reps=20),
                library_ms=graph_ms(lambda: torch.index_select(tiles, 0, rows)),
            )
        record(f"block_fetch_{rpd}tile", r, ms, unit="desc", **extra)

    out = {"table_rows": t, "n_lookups": n, "tile_row_bytes": LANES * 4, "results": results,
           "device": name}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
