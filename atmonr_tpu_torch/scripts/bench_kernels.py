"""Times kernels K1 and K2 on the card at the shapes the shipped configs give
them, under variants of the level plan's constants.

    python -m atmonr_tpu_torch.scripts.bench_kernels            # the plan as it is
    python -m atmonr_tpu_torch.scripts.bench_kernels --sweep    # and its variants

Needs one CUDA device and ``nvcc``. Each line holds the kernel to its plain
version first (K1 exactly; K2 to 1e-4 of max|dW|), then prints its device
time by CUDA-graph replay (K2's includes the zero-fill of dW) and how the
plan took the levels. A variant sets the constants of ``ops/kernel_plan.py``
for one measurement ("all direct" asks for more staged blocks than any
launch has, so every gather and every add goes to global memory). The constants in that module were
set from this script's output; ``PERF.md`` holds the numbers.

Points: ``uniform`` in [0, 1)^D; ``rays``: 24 consecutive samples along each
of M / 24 random rays, in a tenth of the ray's length, as an occupancy
sampler places them (neighbouring threads share cells at the coarse levels
and contend for rows); ``cell``: every point in one cell of the finest level.
"""

from __future__ import annotations

import argparse
import contextlib
import shutil
import subprocess

import torch

from atmonr_tpu_torch import _build
from atmonr_tpu_torch.models.hash_grid import HashGridConfig
from atmonr_tpu_torch.ops import hash_bwd as hbo
from atmonr_tpu_torch.ops import hash_gather as hgo
from atmonr_tpu_torch.ops import kernel_plan as kp
from atmonr_tpu_torch.utils.timing import graph_ms

GRID = {"n_levels": 16, "n_features_per_level": 2, "base_resolution": 16,
        "per_level_scale": 1.3819}
# (label, log2_hashmap_size, D, M, K1 modes timed there)
SHAPES = (
    ("flagship pos", 13, 3, 196_608, ("q8", "bf16", "f32", "f8")),
    ("flagship surface", 13, 2, 8_192, ("q8", "bf16")),
    ("refresh", 13, 3, 131_072, ("q8",)),
    ("extraction batch", 13, 3, 32_768, ("q8",)),
    ("occ14 pos", 14, 3, 196_608, ("q8", "bf16")),
    ("B fine", 15, 3, 524_288, ("bf16",)),
    ("C", 15, 3, 1_048_576, ("bf16", "f32")),
    ("D occ21", 21, 3, 196_608, ("bf16",)),
    ("D instant_ngp", 21, 3, 1_048_576, ("bf16",)),
    ("D surface", 19, 2, 8_192, ("bf16",)),
)
VARIANTS = (
    ("all direct", {"MIN_STAGED_BLOCKS": 1 << 40}),
    # the first design's access pattern: a thread per (point, level), every
    # corner a gather from, or an atomic add to, global memory
    ("all direct, runs of 1", {"MIN_STAGED_BLOCKS": 1 << 40, "MIN_DIRECT_THREADS": 1 << 60}),
    ("target blocks 132", {"TARGET_BLOCKS": 132}),
    ("target blocks 396", {"TARGET_BLOCKS": 396}),
    ("target blocks 792", {"TARGET_BLOCKS": 792}),
    ("gathers per load 2", {"GATHERS_PER_LOAD": 2}),
    ("gathers per load 32", {"GATHERS_PER_LOAD": 32}),
    ("chunk adds per row 4", {"CHUNK_ADDS_PER_ROW": 4}),
    ("chunk adds per row 16", {"CHUNK_ADDS_PER_ROW": 16}),
    ("min staged blocks 1", {"MIN_STAGED_BLOCKS": 1}),
    ("scatter budget whole", {"SCATTER_BUDGET": kp.SHARED_BUDGET}),
    ("direct runs of 1", {"MIN_DIRECT_THREADS": 1 << 60}),
    ("direct runs of 8 always", {"MIN_DIRECT_THREADS": 0}),
)


@contextlib.contextmanager
def plan_constants(values: dict):
    """The plan's constants set to ``values`` inside the block."""
    saved = {name: getattr(kp, name) for name in values}
    for name, value in values.items():
        setattr(kp, name, value)
    kp.level_plan.cache_clear()
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(kp, name, value)
        kp.level_plan.cache_clear()


def points(kind: str, m: int, d: int, cfg: HashGridConfig, gen) -> torch.Tensor:
    dev = gen.device
    if kind == "uniform":
        return torch.rand((m, d), generator=gen, device=dev)
    if kind == "cell":
        cell = 1.0 / cfg.level_scales[-1]
        return 0.37 + 0.9 * cell * torch.rand((m, d), generator=gen, device=dev)
    n_rays = -(-m // 24)
    origin = torch.rand((n_rays, 1, d), generator=gen, device=dev)
    end = torch.rand((n_rays, 1, d), generator=gen, device=dev)
    t0 = 0.9 * torch.rand((n_rays, 1, 1), generator=gen, device=dev)
    t = t0 + 0.1 * torch.sort(torch.rand((n_rays, 24, 1), generator=gen, device=dev), dim=1)[0]
    return (origin + t * (end - origin)).reshape(-1, d)[:m].contiguous()


def bench_k2(x, g, cfg) -> tuple[float, str]:
    got = hbo.hash_bwd(x, g, cfg)
    want = hbo.hash_bwd_plain(x, g, cfg)
    err = float((got - want).abs().max()) / float(want.abs().max())
    if not err <= 1e-4:
        raise RuntimeError(f"K2 disagrees with its plain version: {err} of max|dW|")
    return graph_ms(lambda: hbo.hash_bwd(x, g, cfg)), f"err {err:.1e} of max|dW|"


def bench_k1(mode, table, x, cfg) -> tuple[float, str]:
    prepared, scales = hgo.prepare_table(table, cfg, mode)
    got = hgo.hash_gather(prepared, scales, x, cfg)
    if not torch.equal(got, hgo.hash_gather_plain(prepared, scales, x, cfg)):
        raise RuntimeError(f"K1 {mode} differs from its plain version")
    return graph_ms(lambda: hgo.hash_gather(prepared, scales, x, cfg)), "equal"


def sass_atomics() -> None:
    """Which shared- and global-memory atomic instructions the built
    libraries hold (``cuobjdump -sass``, where the toolkit has it)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("hash_bwd", "hash_gather"):
        path, _ = _build.build(name)
        try:
            sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                                  check=True, timeout=300).stdout
        except (OSError, subprocess.SubprocessError) as err:
            print(f"[sass] {name}: no cuobjdump ({err})")
            return
        counts: dict[str, int] = {}
        for line in sass.splitlines():
            for word in line.replace(";", " ").split():
                if word.startswith(("ATOMS", "ATOMG", "ATOM.", "RED.", "REDG")):
                    counts[word] = counts.get(word, 0) + 1
        print(f"[sass] {name}: {counts}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep", action="store_true", help="also time the plan's variants")
    parser.add_argument("--shapes", default="", help="comma-separated labels (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name, (path, report) in _build.build_all(("hash_gather", "hash_bwd"), verbose=True).items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    sass_atomics()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    variants = (("plan", {}),) + (VARIANTS if args.sweep else ())
    wanted = [s for s in args.shapes.split(",") if s]
    for label, log2, d, m, modes in SHAPES:
        if wanted and label not in wanted:
            continue
        cfg = HashGridConfig.from_options(dict(GRID, log2_hashmap_size=log2), d)
        table = torch.rand((cfg.total_params, 2), generator=gen, device=dev) * 2e-4 - 1e-4
        g = torch.randn((m, cfg.n_output_dims), generator=gen, device=dev)
        for kind in ("uniform", "rays", "cell"):
            x = points(kind, m, d, cfg, gen)
            seen = set()
            for variant, values in variants:
                with plan_constants(values):
                    kernels = [("K2", hbo.ACC_BYTES, True)]
                    if kind != "cell":
                        kernels += [(f"K1 {mode}", hgo.ROW_BYTES[mode], False) for mode in modes]
                    for kernel, row_bytes, scatter in kernels:
                        plan = kp.level_plan(cfg, m, row_bytes, scatter).describe()
                        if (kernel, plan) in seen:
                            continue  # this variant plans this launch as an earlier one did
                        seen.add((kernel, plan))
                        ms, check = (bench_k2(x, g, cfg) if scatter
                                     else bench_k1(kernel[3:], table, x, cfg))
                        print(f"[bench] {label} 2^{log2} D={d} M={m} {kind:7s} {kernel:7s} "
                              f"{variant:23s} {ms:.4f} ms  {check}; {plan}", flush=True)
        del table, g, x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
