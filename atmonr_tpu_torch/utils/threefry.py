"""JAX's default PRNG in numpy: threefry2x32 with the partitionable counter
layout (``jax_threefry_partitionable``, on by default since JAX 0.5), so
that this package can draw the JAX package's parameter inits bit for bit on
a machine without JAX.

A key is a (2,) uint32 array, as ``jax.random.PRNGKey`` gives it.
``uniform`` covers float32 only: the Instant-NGP init draws nothing else.

    key = prng_key(4000)
    k_table, k_mlp = split(key, 2)
    table = uniform(k_table, (1024, 2), -1e-4, 1e-4)
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(
    k0: np.uint32, k1: np.uint32, x0: np.ndarray, x1: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    ``(x0, x1)`` under the key ``(k0, k1)``; uint32 in and out."""
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0) ^ np.uint32(k1) ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed of JAX's default 32-bit
    integers: the high word 0, the low word the seed's 32 bits."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} is outside int32")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _iota_2x32(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """The C-order flat index of every element of ``shape`` as 64 bits in
    two uint32 words (high, low)."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    hi, lo = _iota_2x32((int(num),))
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the cipher of the counter pair
    (0, data)."""
    b0, b1 = threefry2x32(
        key[0], key[1], np.zeros(1, np.uint32), np.array([int(data) & 0xFFFFFFFF], np.uint32)
    )
    return np.array([b0[0], b1[0]], np.uint32)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape``: the two cipher words of each
    element's flat index, xored."""
    hi, lo = _iota_2x32(tuple(shape))
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return b0 ^ b1


def uniform(
    key: np.ndarray, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0
) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 random bits as the mantissa of a float in [1, 2), less 1, then
    ``u * (maxval - minval) + minval`` as one fused multiply-add rounded to
    float32 (XLA:CPU contracts the two under JAX's jit), and no lower than
    ``minval``.

    Emulated in float64, the fused multiply-add is exact where ``minval``
    is 0 or ``-maxval`` (every range this package draws): ``u`` and the
    float32 range carry 24 bits each, so their product is exact, and its sum
    with ``minval`` spans under 53 bits, so the one rounding is the cast to
    float32. Other ranges may differ from JAX by an ulp."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = bits.view(np.float32) - np.float32(1.0)
    scaled = u.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, scaled.astype(np.float32))
