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
  randint(k, shape, minval, maxval)
                   int32 in [minval, maxval) (`jax/_src/random.py::
                   _randint`): (k1, k2) = split(k), hi, lo = random_bits
                   of each; in uint32 arithmetic (wrapping), span =
                   maxval - minval, mult = (2**16 % span)**2 % span (the
                   square wraps too), then
                   minval + ((hi % span) * mult + lo % span) % span
  normal(k, shape) f32 f32(sqrt 2) * erf_inv_f32(u), u = uniform(k, shape,
                   nextafter(-1, 0), 1)  (`jax._src.random._normal_real`)
  normal_bf16(k, shape)
                   `jax.random.normal(k, shape, jnp.bfloat16)`: JAX draws
                   8 bits a bf16 uniform (its mantissa has 7), the low
                   byte of random_bits; the top 7 of them, m, give
                   u = m/64 - (1 - 2**-8), exact in bf16, then erf_inv(u)
                   (f32, rounded to bf16) times bf16(sqrt 2), rounded to
                   bf16: one of 128 values (not the f32 draw rounded)
  dense_init(k, shape, fan_in)
                   erf_inv_f32(u) * f32(f32(sqrt 2) * f32(1 / sqrt(fan_in))):
                   `repro.nn.layers.dense_init` as `jax.jit` compiles it
                   (XLA folds the two constant multiplies into one; an
                   eager, op-by-op call rounds twice and differs in the
                   last bit wherever 1 / sqrt(fan_in) is not a power of 2)

`erf_inv_f32` is XLA:CPU's f32 erf_inv, read from `XLA_FLAGS=
--xla_dump_to=DIR` of `jax.jit(lax.erf_inv)` and of `jax.jit(
jax.random.normal)` (jax 0.9.0, x86-64): the HLO expands erf_inv into
Giles' single-precision polynomial (w = -log1p(-x*x); w < 5 picks the
first coefficient set, on w - 2.5, else the second, on sqrt(w) - 3),
the fusion's `*.ir-with-opt.ll` gives log1p (a Cephes rational for
|t| < sqrt(2) - 1, else XLA:CPU's polynomial log of 1 + t), and
`objdump -d` of its `obj-file.*.o` shows which multiply-adds the backend
fused into vfmadd: every step of the three polynomials, log's
-0.5*y*y + y and its e*ln2_hi term, and log1p's -0.5*t*t term; -x*x,
1 + t, t*t, the division and the last x*p stay plain.  The constants are
written below as their f32 bits.  tests/test_torch_prng.py holds it bit
for bit against live `lax.erf_inv` on every u that `normal` can draw
(2**23 of them) and on the edges, and `normal` and `dense_init` against
`jax.random.normal` and `jax.jit(init_params)`.

The torch half (`normal_into`) draws the same values on any device, for
the model's init (`nn/transformer.py`): threefry on int64 lanes masked to
32 bits, then the same f32 operations, each one torch op (single
rounding on the CPU and on CUDA), but sqrt as the f64 root rounded to f32
(torch's vectorised f32 sqrt on the CPU is off by an ulp on some inputs)
and every fma as `fma_f32` does it in float64 (the product is exact; a
sum that lands on an f32 midpoint is moved toward the exact value).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "fold_in_many", "split", "threefry2x32",
           "random_bits", "uniform", "uniform_rows", "fma_f32",
           "permutation", "choice", "erf_inv_f32", "normal", "normal_range",
           "normal_bf16",
           "dense_init", "init_scale", "normal_into"]

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

    a * b is exact in f64, so f32(f64(p + c)) is the right rounding unless
    the f64 sum s lies exactly halfway between two f32 values (low 29
    mantissa bits 1 << 28, or an odd multiple of 2**-150 below 2**-126)
    while it is inexact; there TwoSum gives the error p + c - s, and the
    result moves to the neighbour on the error's side."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float32)
                                    for v in (a, b, c)))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    r = s.astype(np.float32)
    small = np.abs(s) < 2.0 ** -126
    mid = np.where(small, np.modf(s * 2.0 ** 150)[0] == 0.5,
                   (s.view(np.uint64) & np.uint64(0x1FFFFFFF))
                   == np.uint64(0x10000000))
    if not mid.any():
        return r
    i = np.nonzero(mid)
    pi, ci, si, ri = p[i], c64[i], s[i], r[i]
    bb = si - pi
    err = (pi - (si - bb)) + (ci - bb)
    up = np.where(ri.astype(np.float64) < si,
                  np.nextafter(ri, np.float32(np.inf)), ri)
    down = np.where(ri.astype(np.float64) > si,
                    np.nextafter(ri, np.float32(-np.inf)), ri)
    r = r.copy()
    r[i] = np.where(err > 0, up, np.where(err < 0, down, ri))
    return r


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


def randint(key: np.ndarray, shape: Sequence[int], minval: int,
            maxval: int) -> np.ndarray:
    """int32 of `shape`, as `jax.random.randint(key, shape, minval,
    maxval)` for int32 bounds with minval < maxval."""
    if not np.iinfo(np.int32).min <= minval < maxval <= \
            np.iinfo(np.int32).max:
        raise ValueError(f"need int32 bounds minval < maxval, got "
                         f"{minval}, {maxval}")
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(maxval - minval)
    with np.errstate(over="ignore"):
        mult = np.full(1, 1 << 16, np.uint32) % span
        mult = (mult * mult) % span               # the square wraps
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


# ---- normal draws (erf_inv as XLA:CPU compiles it) ------------------------

def _f32(bits: int) -> np.float32:
    return np.array(bits, np.uint32).view(np.float32)[()]


_SQRT2 = np.float32(math.sqrt(2.0))
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))      # -(1 - 2**-24)
# log(a), a >= FLT_MIN: a = m * 2**e, m in [sqrt(.5), sqrt(2)), y = m - 1
_LOG_SQRTH = 0x3F3504F3
_LOG_P = (0x3D9021BB, 0xBDEBD1B8, 0xBDFE5D4F, 0x3E11E9BF, 0x3E4CCEAC,
          0xBE7FFFFC, 0x3DEF251A, 0xBE2AAE50, 0x3EAAAAAA)
_LN2_LO, _LN2_HI = 0xB95E8083, 0x3F318000
# log1p(t), |t| < sqrt(2) - 1: t - t*t/2 + t**3 * num(t) / den(t)
_LOG1P_SMALL = 0x3ED413CD
_LOG1P_DEN = (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
              0x42707982)
_LOG1P_NUM0 = 0x383DE04B
_LOG1P_NUM = (0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD,
              0x41A05101)
# erf_inv's coefficients (w < 5, w >= 5), highest power first
_ERFINV = ((0x32F16588, 0xB951F09B), (0x34B84B36, 0x38D3B56B),
           (0xB66C7357, 0x3AB0DC72), (0xB6935AC1, 0xBB70BDE7),
           (0x396532DB, 0x3BBC127B), (0xBAA45408, 0xBBF9C5D7),
           (0xBB88E4EF, 0x3C1AA57E), (0x3E7C8F63, 0x3F8036DB),
           (0x3FC02E2F, 0x40354F7E))


class _NumpyF32:
    """f32 arithmetic on numpy arrays (each operation rounded once)."""
    fma = staticmethod(fma_f32)
    where = staticmethod(np.where)
    sqrt = staticmethod(np.sqrt)

    @staticmethod
    def c(bits):
        return _f32(bits)

    @staticmethod
    def bits(x):
        return x.view(np.int32).astype(np.int64)

    @staticmethod
    def from_bits(b):
        return b.astype(np.int32).view(np.float32)

    @staticmethod
    def to_f32(x):
        return x.astype(np.float32)


class _TorchF32:
    """The same operations on f32 torch tensors, on any device."""
    where = staticmethod(torch.where)

    @staticmethod
    def sqrt(x):
        """Correctly rounded (torch's f32 sqrt on the CPU is not): the f64
        root rounded to f32."""
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)

    @staticmethod
    def c(bits):
        return float(_f32(bits))

    @staticmethod
    def bits(x):
        return x.view(torch.int32).to(torch.int64)

    @staticmethod
    def from_bits(b):
        return b.to(torch.int32).view(torch.float32)

    @staticmethod
    def to_f32(x):
        return x.to(torch.float32)

    @staticmethod
    def fma(a, b, c):
        """a * b + c rounded once, as `fma_f32`; a scalar operand is an f32
        value (a python float)."""
        a, b, c = (v.to(torch.float64) if isinstance(v, torch.Tensor)
                   else float(v) for v in (a, b, c))
        p = a * b
        s = p + c
        r = s.to(torch.float32)
        cand = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) \
            | ((s.abs() < 2.0 ** -126) & (s != 0))
        if not bool(cand.any()):
            return r
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        small = s.abs() < 2.0 ** -126
        mid = torch.where(small, torch.frac(s * 2.0 ** 150).abs() == 0.5,
                          cand) & (err != 0)
        if not bool(mid.any()):             # exact midpoints: r is right
            return r
        r64 = r.to(torch.float64)
        inf = torch.full_like(r, math.inf)
        up = torch.where(r64 < s, torch.nextafter(r, inf), r)
        down = torch.where(r64 > s, torch.nextafter(r, -inf), r)
        return torch.where(mid, torch.where(err > 0, up, down), r)


def _log_f32(a, F):
    """XLA:CPU's f32 log of a (a = 1 + t > 0 on erf_inv's path; 0 gives
    -inf, +inf gives +inf, a < 0 or NaN gives NaN)."""
    c = F.c
    m = F.where(a > c(0x00800000), a, c(0x00800000))
    bits = F.bits(m)
    e = F.to_f32((bits >> 23) - 127) + 1.0
    mm = F.from_bits((bits & 0x7FFFFF) | 0x3F000000)
    low = mm < c(_LOG_SQRTH)
    y = (mm + -1.0) + F.where(low, mm, 0.0 * mm)
    e = F.where(low, e - 1.0, e)
    y2 = y * y
    y3 = y2 * y
    P = [c(b) for b in _LOG_P]
    p1 = F.fma(F.fma(y, P[0], P[1]), y, P[6])
    p2 = F.fma(F.fma(y, P[2], P[3]), y, P[7])
    p3 = F.fma(F.fma(y, P[4], P[5]), y, P[8])
    q = F.fma(F.fma(F.fma(p1, y3, p2), y3, p3), y3, e * c(_LN2_LO))
    r = F.fma(e, c(_LN2_HI), F.fma(-0.5, y2, y) + q)
    r = F.where(a == math.inf, math.inf, r)
    r = F.where(a == 0, -math.inf, r)
    return F.where((a < 0) | (a != a), math.nan, r)


def _log1p_f32(t, F):
    c = F.c
    big = _log_f32(t + 1.0, F)
    t2 = t * t
    z = t * 0.0
    den = z + 1.0
    for b in _LOG1P_DEN:
        den = F.fma(den, t, c(b))
    num = z + c(_LOG1P_NUM0)
    for b in _LOG1P_NUM:
        num = F.fma(num, t, c(b))
    small = t + F.fma(-0.5, t2, (t * t2) * (num / den))
    return F.where(abs(t) < c(_LOG1P_SMALL), small, big)


def _erf_inv(x, F):
    lg = _log1p_f32((-x) * x, F)          # -w
    lt = lg > -5.0                          # w < 5
    w = F.where(lt, -2.5 - lg, F.sqrt(-lg) + -3.0)
    p = F.where(lt, F.c(_ERFINV[0][0]), F.c(_ERFINV[0][1]))
    for b_lt, b_ge in _ERFINV[1:]:
        p = F.fma(w, p, F.where(lt, F.c(b_lt), F.c(b_ge)))
    p = F.where(abs(x) == 1.0, math.inf, p)
    return x * p


def erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """f32 erf_inv exactly as XLA:CPU computes it (module docstring);
    erf_inv(+-1) = +-inf."""
    x = np.asarray(x, np.float32)
    with np.errstate(all="ignore"):
        return _erf_inv(x, _NumpyF32).astype(np.float32)


def _uniform_normal_domain(bits):
    """uniform(., lo, 1) from 32 random bits: floats * 2 is exact, so the
    fma of `uniform` is one rounded add here."""
    one = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    f = one.view(np.float32) - np.float32(1.0)
    return np.maximum(_LO, f * np.float32(2.0) + _LO)


def normal_range(key: np.ndarray, start: int, n: int, scale: np.float32
                 ) -> np.ndarray:
    """(n,) f32: erf_inv(u_i) * scale for i in [start, start + n), u_i the
    i-th uniform of `normal(key, .)` (numpy's counterpart of
    `normal_into`)."""
    if start + n > 1 << 32:
        raise ValueError("normal_range draws counters below 2**32 only")
    i = np.arange(start, start + n, dtype=np.uint64).astype(np.uint32)
    y0, y1 = threefry2x32(key, np.zeros_like(i), i)
    return erf_inv_f32(_uniform_normal_domain(y0 ^ y1)) * np.float32(scale)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """f32 of `shape`, as `jax.random.normal(key, shape)`."""
    n = int(np.prod(shape, dtype=np.int64))
    return normal_range(key, 0, n, _SQRT2).reshape(tuple(shape))


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@functools.lru_cache(maxsize=1)
def _normal_bf16_values() -> torch.Tensor:
    """The 128 values of a bf16 normal, by the 7 bits m that pick them."""
    u = (np.arange(128, dtype=np.float32) * np.float32(4.0)
         - np.float32(255.0)) / np.float32(256.0)
    e = _bf16(erf_inv_f32(u)).float()
    return (e * _bf16(_SQRT2).float()).to(torch.bfloat16)


def normal_bf16(key: np.ndarray, shape: Sequence[int]) -> torch.Tensor:
    """bf16 tensor of `shape` on the CPU, as `jax.random.normal(key,
    shape, jnp.bfloat16)` (module docstring)."""
    m = (random_bits(key, shape) & np.uint32(0xFF)) >> np.uint32(1)
    return _normal_bf16_values()[torch.from_numpy(m.astype(np.int64))]


def init_scale(fan_in: Optional[int]) -> np.float32:
    """The one f32 constant a jitted init multiplies erf_inv(u) by:
    f32(sqrt 2) for an unscaled normal (fan_in None), else
    f32(f32(sqrt 2) * f32(1 / sqrt(max(1, fan_in))))."""
    if fan_in is None:
        return _SQRT2
    return _SQRT2 * np.float32(1.0 / math.sqrt(max(1, fan_in)))


def dense_init(key: np.ndarray, shape: Sequence[int], fan_in: int
               ) -> np.ndarray:
    """f32 of `shape`, as `repro.nn.layers.dense_init` under `jax.jit`."""
    n = int(np.prod(shape, dtype=np.int64))
    return normal_range(key, 0, n, init_scale(fan_in)).reshape(tuple(shape))


# ---- the same draws in torch, on any device -------------------------------

_M32 = 0xFFFFFFFF


def _threefry_t(key: np.ndarray, x1: torch.Tensor):
    """threefry2x32(key, (0, x1)) on int64 lanes holding uint32 values;
    returns y0 ^ y1 (int64 in [0, 2**32))."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = torch.full_like(x1, ks[0])
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _M32)) & _M32
    return x0 ^ x1


@torch.no_grad()
def normal_into(out: torch.Tensor, key: np.ndarray, scale: np.float32,
                start: int = 0, chunk: int = 1 << 24) -> torch.Tensor:
    """Fill the contiguous 1-D `out` with erf_inv(u_i) * scale for i in
    [start, start + out.numel()), u_i the i-th `normal` uniform of `key`
    (so scale = init_scale(None) gives `normal(key, .)`'s values and
    init_scale(fan_in) `dense_init`'s), chunk by chunk on out's device:
    no temporary exceeds `chunk` elements of int64."""
    n = out.numel()
    if start + n > 1 << 32:
        raise ValueError("normal_into draws counters below 2**32 only")
    lo, two = float(_LO), 2.0
    for s0 in range(0, n, chunk):
        m = min(chunk, n - s0)
        ctr = torch.arange(start + s0, start + s0 + m, dtype=torch.int64,
                           device=out.device)
        bits = _threefry_t(key, ctr)
        del ctr
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        del bits
        u = torch.clamp_min(((f - 1.0) * two) + lo, lo)
        out[s0:s0 + m].copy_(_erf_inv(u, _TorchF32) * float(scale))
    return out
