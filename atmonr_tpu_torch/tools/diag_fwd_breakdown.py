"""Where the hash-encode forward's time goes, on the card at the flagship's
scale: the counterpart of the JAX repo's ``tools/diag_fwd_breakdown.py``.

The flagship's position grid (16 levels, 2^13 entries, D = 3) over
M = 8,192 x 24 = 196,608 uniform points, in the bf16 and q8 modes, split
into:

- ``prepare_table``: the table as the kernel reads it (``ops/hash_gather.py::
  prepare_table``: the bf16 cast; the q8 quantizer, kernel K1p of
  ``csrc/quantize.cu`` on a card, by nearest rounding and, as the flagship
  trains, with stochastic-rounding noise);
- the position relayout: none, the kernel reads the (M, 3) positions as
  they are (the TPU kernel's wrapper transposes them to 128 lanes);
- K1 alone (``launch_kernel``: the kernel body launched without the
  wrapper's checks and allocation, its level plan made once; the JAX
  tool's ``kernel_only``);
- the whole ``hash_encode`` (preparation and the wrapped kernel).

Each is timed as the JAX tool times it (one call, 80 warm calls, then 50
calls between two syncs: ms a call with the host's launch work) and, on a
card, by CUDA-graph replay (device ms).

    python -m atmonr_tpu_torch.tools.diag_fwd_breakdown
"""

from __future__ import annotations

import torch

from atmonr_tpu_torch.utils.timing import graph_ms, wall_s

GRID = {"n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 13,
        "base_resolution": 16, "per_level_scale": 1.3819}
M = 8192 * 24


def timed(fn, device: torch.device, label: str, iters: int = 50, warm: int = 80) -> dict:
    """ms a call (host clock around ``iters`` calls between syncs, after a
    call and ``warm`` more) and, on a card, device ms by graph replay."""
    ms = wall_s(fn, device, iters, warm + 1) * 1e3
    dev_ms = graph_ms(fn) if device.type == "cuda" else None
    device_part = f", device {dev_ms:8.4f} ms" if dev_ms is not None else ""
    print(f"{label:34s} {ms:8.4f} ms a call{device_part}", flush=True)
    return {"ms": ms, "device_ms": dev_ms}


def main(*, device: str | torch.device | None = None, m: int = M, iters: int = 50,
         warm: int = 80) -> dict[str, dict]:
    """Prints a line a piece and returns their times by ``"<mode> <piece>"``;
    ``device`` is ``cuda`` unless given. On the CPU the kernel alone is not
    timed (there is none)."""
    from atmonr_tpu_torch.models import hash_grid as hg
    from atmonr_tpu_torch.ops import hash_gather as hgo
    from atmonr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for mode in ("bf16", "q8"):
        cfg = hg.HashGridConfig.from_options(dict(GRID, fwd_mode=mode), 3)
        table = hg.init_hash_table(cfg, torch.Generator().manual_seed(0), dev)
        noise = torch.rand(table.shape, generator=gen, device=dev)
        x = torch.rand((m, 3), generator=gen, device=dev)
        print(f"--- mode={mode}, M={m}, T={cfg.total_params}, on {name}", flush=True)
        out[f"{mode} prepare_table"] = timed(
            lambda: hgo.prepare_table(table, cfg, mode), dev, "prepare_table", iters, warm)
        if mode == "q8":
            out["q8 prepare_table noise"] = timed(
                lambda: hgo.prepare_table(table, cfg, mode, noise), dev,
                "prepare_table (stochastic rounding)", iters, warm)
        print(f"{'position relayout':34s} none: the kernel reads (M, 3) as it is", flush=True)
        prepared, scales = hgo.prepare_table(table, cfg, mode)
        if dev.type == "cuda":
            feats = torch.empty((m, cfg.n_output_dims), dtype=torch.float32, device=dev)
            plan = hgo.level_plan(cfg, m, hgo.ROW_BYTES[mode], False)
            out[f"{mode} kernel only"] = timed(
                lambda: hgo.launch_kernel(prepared, scales, x, feats, cfg, mode, plan), dev,
                "kernel only", iters, warm)
            if not torch.equal(feats, hgo.hash_gather_plain(prepared, scales, x, cfg)):
                raise RuntimeError(f"K1 {mode} alone differs from its plain version")

        def whole():
            with torch.no_grad():
                return hg.hash_encode(table, x, cfg)

        out[f"{mode} hash_encode"] = timed(whole, dev, "hash_encode (prepare + K1)", iters, warm)
        share = out[f"{mode} prepare_table"]["device_ms" if dev.type == "cuda" else "ms"]
        whole_ms = out[f"{mode} hash_encode"]["device_ms" if dev.type == "cuda" else "ms"]
        print(f"{'prepare_table share of the encode':34s} {share / whole_ms:8.1%} "
              f"({'device' if dev.type == 'cuda' else 'host'} time)", flush=True)
    return out


if __name__ == "__main__":
    main()
