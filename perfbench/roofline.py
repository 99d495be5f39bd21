"""The card's published peaks, and the operations and bytes of the work the
per-layer roofline and utilization metrics count, from the work's shapes.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W): 989 TFLOP/s
in bf16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.
A roofline share is the least time the chip could take (the larger of
operations over the peak and bytes over the bandwidth) over the measured
time. Each input byte is read once and each output byte written once."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def encode_fwd(points: int, dims: int, levels: int, features: int, rows: int,
               table_bytes: int = 4, noise: bool = False) -> tuple[float, float]:
    """(flops, bytes) of a hash-encode forward: per point and level, 2^D
    corner weights (D - 1 products each) and a multiply-add per corner and
    feature; reads the table (``table_bytes`` an entry; the float32 master
    table is 4), its stochastic-rounding noise where given (4 bytes an
    entry), the points (float32), and writes the float32 features."""
    corners = 1 << dims
    flops = points * levels * corners * ((dims - 1) + 2 * features)
    nbytes = rows * features * table_bytes + (rows * features * 4 if noise else 0)
    nbytes += points * dims * 4 + points * levels * features * 4
    return float(flops), float(nbytes)


def encode_bwd(points: int, dims: int, levels: int, features: int, rows: int
               ) -> tuple[float, float]:
    """(flops, bytes) of a hash-table gradient: per point, level and corner
    the weight and a multiply-add per feature into the table; reads the
    points and the float32 cotangents, writes the float32 gradient table."""
    corners = 1 << dims
    flops = points * levels * corners * ((dims - 1) + 2 * features)
    nbytes = points * dims * 4 + points * levels * features * 4 + rows * features * 4
    return float(flops), float(nbytes)


def mlp_flops(points: int, layers: list[tuple[int, int]], backward: bool) -> float:
    """Products of a bias-free MLP's (out, in) layers over ``points`` rows:
    2 m n k forward, and twice that again backward (the input's and the
    weight's gradients)."""
    f = sum(2.0 * points * o * i for o, i in layers)
    return 3.0 * f if backward else f
