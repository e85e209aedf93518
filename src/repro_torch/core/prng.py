"""JAX's counter-based random streams in numpy (threefry2x32), so that the
port draws the same batches and straggler masks as the JAX package for the
same seed.

The port's own copy of what it needs from `jax.random` (jax 0.9 defaults:
the threefry2x32 implementation and `jax_threefry_partitionable=True`);
nothing here imports JAX.  Keys are (2,) uint32 arrays, as JAX's raw keys
with x64 off (the JAX package's setting):

  PRNGKey(seed)    [0, seed & 0xffffffff] (JAX reduces the seed to 32 bits)
  fold_in(k, d)    threefry2x32(k, (0, d)): the two output words
                   (`fold_in_many`: many data, or one key per datum)
  random_bits(k, shape)
                   element i (flat, row-major) is y0 ^ y1 of
                   threefry2x32(k, (i >> 32, i & 0xffffffff))
  uniform(k, shape, minval, maxval)
                   f32 in [minval, maxval): the top 23 bits as a mantissa
                   of [1, 2), minus 1 (exact), then
                   fma(., maxval - minval, minval) rounded once, because
                   XLA:CPU contracts JAX's multiply-add into an FMA
                   (tests/test_torch_prng.py holds this against
                   jax.random), then max(minval, .)
                   (`uniform_rows`: one (n,) draw per key of a batch)
  split(k, num)    key i is the two output words of
                   threefry2x32(k, (i >> 32, i & 0xffffffff))
  permutation(k, n)
                   arange(n) shuffled as `jax/_src/random.py::_shuffle`:
                   ceil(3 ln(max(1, n)) / ln(2**32 - 1)) rounds, each
                   (k, sub) = split(k), then a stable sort of the array by
                   random_bits(sub, (n,)) as unsigned keys
  choice(k, n, (m,), replace=False)
                   permutation(k, n)[:m]
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["PRNGKey", "fold_in", "fold_in_many", "split", "threefry2x32",
           "random_bits", "uniform", "uniform_rows", "fma_f32",
           "permutation", "choice"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block function (Salmon et al. 2011, as
    `jax._src.prng.threefry2x32`) on uint32 counters (x0, x1) of any
    shape; returns the two uint32 output words.  `key` is one (2,) key or
    keys (..., 2) that broadcast against the counters."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """JAX's raw threefry key of an integer seed (x64 off)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """The key of `jax.random.fold_in(key, data)` for a 32-bit data word."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def fold_in_many(key: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(len(data), 2) keys: row i is `fold_in(key_i, data[i])`, where key
    is one (2,) key or one key per datum (len(data), 2); data are taken
    modulo 2**32 (negative steps wrap as JAX's cast to uint32)."""
    d = (np.asarray(data, np.int64) % (1 << 32)).astype(np.uint32)
    y0, y1 = threefry2x32(key, np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1)


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """(num, 2) uint32 keys, as `jax.random.split(key, num)` (the
    partitionable, fold-like split of jax 0.9)."""
    y0, y1 = threefry2x32(key, *_counters(int(num)))
    return np.stack([y0, y1], axis=1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """uint32 bits of `shape`, as `jax.random.bits(key, shape)`."""
    y0, y1 = threefry2x32(key, *_counters(int(np.prod(shape,
                                                      dtype=np.int64))))
    return (y0 ^ y1).reshape(tuple(shape))


def fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c for f32 arrays, rounded once to f32 (round to nearest,
    ties to even), as a fused multiply-add.

    a * b is exact in f64 and TwoSum gives p + c = s + err exactly, so
    f32(s) is the right rounding unless s lies exactly halfway between two
    f32 values while err != 0; then the exact sum lies on err's side."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    toward = np.where(s > r.astype(np.float64), np.float32(np.inf),
                      np.float32(-np.inf))
    other = np.nextafter(r, toward)
    mid = (r.astype(np.float64) + other.astype(np.float64)) * 0.5
    fix = (s == mid) & (err != 0)
    lo_, hi_ = np.minimum(r, other), np.maximum(r, other)
    return np.where(fix, np.where(err > 0, hi_, lo_), r)


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """f32 of `shape`, as `jax.random.uniform(key, shape, jnp.float32,
    minval, maxval)`."""
    return _bits_to_uniform(random_bits(key, shape), minval, maxval)


def uniform_rows(keys: np.ndarray, n: int) -> np.ndarray:
    """(K, n) f32 in [0, 1): row i is `uniform(keys[i], (n,))`, for keys
    (K, 2), in one vectorised pass."""
    y0, y1 = threefry2x32(np.asarray(keys, np.uint32)[:, None, :],
                          *_counters(int(n)))
    return _bits_to_uniform(y0 ^ y1, 0.0, 1.0)


def _bits_to_uniform(bits: np.ndarray, minval: float, maxval: float
                     ) -> np.ndarray:
    lo, hi = np.float32(minval), np.float32(maxval)
    one = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = one.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, fma_f32(floats, hi - lo, lo))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """(n,) int32, as `jax.random.permutation(key, n)`."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = np.argsort(random_bits(sub, (n,)), kind="stable")
        x = x[order]
    return x


def choice(key: np.ndarray, n: int, shape: Sequence[int],
           replace: bool = False) -> np.ndarray:
    """int32 of `shape`, as `jax.random.choice(key, n, shape,
    replace=False)`: the first prod(shape) entries of a permutation."""
    if replace:
        raise NotImplementedError("the port draws without replacement only "
                                  "(RandK)")
    m = int(np.prod(shape, dtype=np.int64))
    if m > n:
        raise ValueError(f"cannot take {m} of {n} without replacement")
    return permutation(key, n)[:m].reshape(tuple(shape))
