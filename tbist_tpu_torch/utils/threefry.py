"""JAX's default PRNG (threefry2x32) in numpy.

The JAX package draws two things the port must reproduce without JAX: the
prompt-seeded CLIP fallback embedding
(``jax.random.normal(jax.random.key(crc32(prompt)), (1, 512))``) and the
seeded Ghiasi/CLIP-MLP weights (``jax.random.uniform`` under ``split`` and
``fold_in``). This module computes the same bits as JAX 0.9.0 with its
default ``jax_threefry_partitionable=True``: a key is a (2,) uint32 pair,
and the counter of element i of a draw is the 64-bit i split into (hi, lo)
words. XLA on the CPU contracts a multiply-add into one fused
multiply-add, so the products below are formed in f64 (exact for f32
operands) and rounded once. ``uniform`` is bit-exact. ``normal`` applies
XLA's f32 ``erf_inv`` polynomial (Giles' approximation, as XLA lowers
``lax.erf_inv``) with numpy's ``log1p``: XLA's own ``log1p`` rounds the
last bit differently now and then, so about 99% of a normal draw's entries
equal JAX's bits and the rest are one ulp away.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 hash of the counter pairs (x0, x1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
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


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s raw words: [seed >> 32, seed & 0xFFFFFFFF]."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` -> (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(k, *_counters(num))
    return np.stack([b0, b1], axis=1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: the hash of the pair [0, data]."""
    b0, b1 = threefry2x32(k, np.zeros(1, np.uint32), np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def random_bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    n = int(np.prod(shape, dtype=np.int64))
    b0, b1 = threefry2x32(k, *_counters(n))
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(k: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``, bit-exact.

    ``minval``/``maxval`` are rounded to f32 first, as JAX converts them."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c) -> np.ndarray:
    """a·b + c rounded once to f32, as XLA's fused multiply-add."""
    return (np.float64(1.0) * a * b + c).astype(np.float32)


_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                          1.50140941], np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                          2.83297682], np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv``: a degree-8 polynomial in w = -log1p(-x²)."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for i in range(1, len(_ERFINV_SMALL)):
        p = _fma(p, w, np.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i]))
    with np.errstate(over="ignore"):
        return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x).astype(np.float32)


def normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``: √2·erf_inv of a uniform
    draw on [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)
