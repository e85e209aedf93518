"""The port's copy of JAX's random streams (`repro_torch/core/prng.py`)
against `jax.random` (jax 0.9, x64 off, threefry partitionable), and the
batches and straggler masks the port draws from it against the JAX
package's for the same seed.

Tolerances and why:
  - keys, bits, uniforms and masks: bit-equal.
  - batch weights: bit-equal.
  - tokens: equal, through `pipeline.xla_cpu_exp_f32`, the port's copy of
    XLA:CPU's f32 exp, which is held bit for bit against live `jnp.exp`
    on this CPU (torch's exp differed from it in the last bit on some
    inputs, and 6 of the 65,664 tokens at vocab 256,000 then flipped).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro.data import pipeline as jpipeline
from repro_torch.core import coding, prng
from repro_torch.data import pipeline
from repro_torch.sim.stragglers import IIDBernoulli

SEEDS = [0, 1, 12345, 2**32 - 1, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    pkey = prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), pkey)
    for data in (0, 1, 7, 2**31 + 5, 2**32 - 1):
        kj = jax.random.fold_in(key, np.uint32(data))
        kp = prng.fold_in(pkey, data)
        np.testing.assert_array_equal(np.asarray(kj), kp)
        for shape in ((1,), (4,), (3, 7), (33, 513), (2, 5, 11)):
            np.testing.assert_array_equal(
                np.asarray(jax.random.bits(kj, shape)),
                prng.random_bits(kp, shape))
            for lo, hi in ((0.0, 1.0), (1e-6, 1.0), (-2.5, 3.0)):
                uj = np.asarray(jax.random.uniform(kj, shape, minval=lo,
                                                   maxval=hi))
                up = prng.uniform(kp, shape, lo, hi)
                assert up.dtype == np.float32 and up.shape == shape
                np.testing.assert_array_equal(uj.view(np.int32),
                                              up.view(np.int32))


def test_fma_f32_rounds_once():
    """fma_f32 against exact rational arithmetic, on random inputs and on
    inputs whose f64 sum lands on an f32 midpoint."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    n = 3000
    cases = [(rng.standard_normal(n), rng.standard_normal(n),
              rng.standard_normal(n) * np.exp(rng.uniform(-30, 30, n))),
             (np.full(n, 2.0**-24), 1 + rng.integers(-3, 4, n) * 2.0**-20,
              np.ones(n))]
    for a, b, c in cases:
        a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
        got = prng.fma_f32(a, b, c)
        for i in range(0, n, 3):
            exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
                + Fraction(float(c[i]))
            f = np.float32(float(exact))
            cands = [np.nextafter(f, np.float32(-np.inf)), f,
                     np.nextafter(f, np.float32(np.inf))]
            dist = [abs(Fraction(float(x)) - exact) for x in cands]
            best = [x for x, d in zip(cands, dist) if d == min(dist)]
            if len(best) > 1:                         # ties to even
                best = [x for x in best if not x.view(np.int32) & 1]
            assert got[i].view(np.int32) == best[0].view(np.int32)


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5])
@pytest.mark.parametrize("num_devices", [4, 7])
def test_straggler_mask_equals_jax(p, num_devices):
    proc = IIDBernoulli(num_devices, p)
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        for step in range(12):
            want = np.asarray(jcoding.straggler_mask(key, step, num_devices,
                                                     p))
            got = proc.mask(seed, step)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


def test_xla_cpu_exp_equals_jnp_exp():
    """`xla_cpu_exp_f32` against live `jnp.exp` on this CPU, bit for bit,
    on more than 2**22 f32 inputs: the token map's whole range
    [1e-6 * log V, log V) at vocab 256,000 on a grid of 2**21 points, the
    f32 log of every integer up to V + 1 with its three neighbours on
    either side (where floor(exp(.)) changes), uniform draws over the
    clamp range, the clamp edges, and the results that flush to +0."""
    V = 256_000
    lv = np.float32(math.log(V))
    rng = np.random.default_rng(0)
    logs = np.log(np.arange(1, V + 2, dtype=np.float64)).astype(np.float32)
    near = [logs]
    for way in (np.inf, -np.inf):
        x = logs
        for _ in range(3):
            x = np.nextafter(x, np.float32(way))
            near.append(x)
    x = np.concatenate(
        [np.linspace(np.float32(1e-6) * lv, lv, 1 << 21, dtype=np.float32),
         rng.uniform(-90, 90, 1 << 20).astype(np.float32), *near,
         np.array([-87.8, 88.8, -87.80001, 88.80001, -100, 100, 0, -0.0,
                   88.72, 88.73, -87.33, -87.34], np.float32)])
    assert x.size >= 1 << 22
    got = pipeline.xla_cpu_exp_f32(x)
    want = np.asarray(jax.jit(jnp.exp)(x))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_coded_train_batch_equals_jax():
    """Weights and tokens bit for bit, at vocab 256,000."""
    N, d, per_subset, seq_len, vocab = 4, 2, 4, 512, 256000
    alloc = coding.cyclic_allocation(N, N, d)
    jalloc = jcoding.cyclic_allocation(N, N, d)
    np.testing.assert_array_equal(alloc.S, jalloc.S)
    rates = np.full(N, 0.9)
    W = np.asarray(jcoding.encode_weights(jalloc, rates=rates))
    np.testing.assert_array_equal(
        coding.encode_weights(alloc, rates=rates), W)
    for seed, step in ((0, 0), (0, 1), (7, 3), (2**32 - 1, 5)):
        toks, wts = pipeline.coded_train_batch(seed, step, alloc, W,
                                               per_subset, seq_len, vocab)
        jt, jw = jpipeline.coded_train_batch(jax.random.PRNGKey(seed), step,
                                             jalloc, jnp.asarray(W),
                                             per_subset, seq_len, vocab)
        jt, jw = np.asarray(jt), np.asarray(jw)
        assert toks.shape == jt.shape and toks.dtype == torch.int64
        np.testing.assert_array_equal(wts.numpy().view(np.int32),
                                      jw.view(np.int32))
        np.testing.assert_array_equal(toks.numpy(), jt)
