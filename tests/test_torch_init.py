"""The port's normal draws and parameter init (`core/prng.py`,
`nn/transformer.py::init_keys`, `Model.init_`) against JAX's.

  - `prng.erf_inv_f32` (numpy) and the torch erf_inv of `normal_into`
    against live `lax.erf_inv` (and `jax.scipy.special.erfinv`, the same
    op) under `jax.jit` on every u that `normal`
    can draw (2**23 of them: the uniform's mantissas mapped to
    [nextafter(-1, 0), 1)) and on the edges (+-1, +-0, tiny, near +-1);
  - the torch fma against exact rational arithmetic;
  - `normal` against `jax.random.normal`, `dense_init` against
    `jax.jit(repro.nn.layers.dense_init)`, `normal_into` (chunked, at an
    offset) against `normal`;
  - `Model.init_(seed)` against `jax.jit(Model(cfg).init)(PRNGKey(seed))`
    (the driver's `setup.init_state`) on the smoke config, and the
    serving model and the driver's setup on the same path.

Tolerance: none, every comparison is bit for bit.  (An eager, op-by-op
`init_params` rounds erf_inv(u) * sqrt 2 and then * 1/sqrt(fan_in); the
jitted one folds the two constants, which both JAX entry points run.)
"""
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import jax.scipy.special
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import REGISTRY as JREGISTRY
from repro.nn import layers as jlayers
from repro.nn.models import Model as JModel
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.launch.serve import build_serve_setup
from repro_torch.launch.train import TrainRun, build_train_setup
from repro_torch.nn.models import Model
from repro_torch.nn.transformer import init_keys

SPEC = REGISTRY["gemma2-2b"]
EDGES = np.array([1.0, 0.0, -0.0, 1e-30, 2.0 ** -24, 2.0 ** -60, 1e-7,
                  3e-4, 0.41, 0.5, 0.9, 0.993, 0.9933, 0.999999,
                  0.99999994, float(np.nextafter(np.float32(1), 0))],
                 np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _normal_domain():
    """Every u that `normal` can draw, then the edges and their negatives."""
    m = np.arange(1 << 23, dtype=np.uint32)
    f = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, f * np.float32(2) + lo)
    return np.concatenate([u, EDGES, -EDGES])


@pytest.fixture(scope="module")
def domain():
    u = _normal_domain()
    want = np.asarray(jax.jit(lax.erf_inv)(u))
    np.testing.assert_array_equal(                # the public name: the
        _bits(np.asarray(jax.jit(jax.scipy.special.erfinv)(u))),  # same op
        _bits(want))
    return u, want


def test_torch_erf_inv_equals_xla_on_every_normal_draw(domain):
    u, want = domain
    got = prng._erf_inv(torch.from_numpy(u), prng._TorchF32).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("part", range(4))
def test_numpy_erf_inv_equals_xla(domain, part):
    """The numpy copy on a quarter of the draws (every 4th) plus edges."""
    u, want = domain
    sel = np.concatenate([np.arange(part, u.size - 2 * EDGES.size, 4),
                          np.arange(u.size - 2 * EDGES.size, u.size)])
    got = prng.erf_inv_f32(u[sel])
    np.testing.assert_array_equal(_bits(got), _bits(want[sel]))
    assert np.isposinf(got[-2 * EDGES.size]) and \
        np.isneginf(got[-EDGES.size])                   # erf_inv(+-1)


def test_torch_fma_rounds_once():
    """The torch fma against exact rational arithmetic, on random inputs,
    on sums that land on f32 midpoints, and on subnormal sums."""
    rng = np.random.default_rng(1)
    n = 3000
    cases = [(rng.standard_normal(n), rng.standard_normal(n),
              rng.standard_normal(n) * np.exp(rng.uniform(-30, 30, n))),
             (np.full(n, 2.0 ** -24), 1 + rng.integers(-3, 4, n) * 2.0 ** -20,
              np.ones(n)),
             (rng.standard_normal(n) * 2.0 ** -75,
              rng.standard_normal(n) * 2.0 ** -60,
              rng.integers(-9, 9, n) * 2.0 ** -149)]
    for a, b, c in cases:
        a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
        got = prng._TorchF32.fma(*(torch.from_numpy(v) for v in (a, b, c)))
        got = got.numpy()
        np.testing.assert_array_equal(_bits(got), _bits(prng.fma_f32(a, b, c)))
        for i in range(0, n, 7):
            exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
                + Fraction(float(c[i]))
            f = np.float32(float(exact))
            cands = [np.nextafter(f, np.float32(-np.inf)), f,
                     np.nextafter(f, np.float32(np.inf))]
            dist = [abs(Fraction(float(x)) - exact) for x in cands]
            best = [x for x, d in zip(cands, dist) if d == min(dist)]
            if len(best) > 1:
                best = [x for x in best if not x.view(np.int32) & 1]
            assert _bits(got[i]) == _bits(best[0])


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 32 - 1])
def test_normal_and_dense_init_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    for shape in ((1,), (7,), (33, 17), (4, 3, 5), (1000,)):
        want = np.asarray(jax.random.normal(key, shape))
        np.testing.assert_array_equal(
            _bits(prng.normal(prng.PRNGKey(seed), shape)), _bits(want))
    for shape, fan in (((33, 17), 1), ((1000,), 48), ((4, 3, 5), 128),
                       ((1000,), 2304), ((33, 17), 9216)):
        jd = jax.jit(lambda k, f=fan, s=shape: jlayers.dense_init(
            k, s, f, jnp.float32))
        np.testing.assert_array_equal(
            _bits(prng.dense_init(prng.PRNGKey(seed), shape, fan)),
            _bits(np.asarray(jd(key))))


def test_normal_into_chunks_and_offsets():
    key = prng.PRNGKey(9)
    want = prng.normal(key, (5000,))
    out = torch.empty(3001)
    prng.normal_into(out, key, prng.init_scale(None), start=1234, chunk=700)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(want[1234:4235]))
    scaled = torch.empty(5000)
    prng.normal_into(scaled, key, prng.init_scale(96), chunk=4096)
    np.testing.assert_array_equal(
        _bits(scaled.numpy()), _bits(prng.dense_init(key, (5000,), 96)))


def _jax_params(seed):
    p = jax.jit(JModel(JREGISTRY["gemma2-2b"].smoke).init)(
        jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree.map(np.asarray, p))


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(_bits(v.numpy()), _bits(want[k].numpy()),
                                      err_msg=k)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_model_init_equals_jax_init_params(seed):
    m = Model(SPEC.smoke, chunk_ranks=4, group_size=32, device="cpu")
    m.init_(seed)
    _assert_params_equal(m.params(), _jax_params(seed))
    assert m.theta[m.layout.total:].abs().max() == 0        # padding


def test_init_keys_walk_equals_numpy_dense_init():
    """The key tree through numpy's draws (`prng.dense_init`, `normal`)
    equals the torch init leaf by leaf: the reference the card's init is
    checked against."""
    cfg = SPEC.smoke
    m = Model(cfg, device="cpu", with_grad=False)
    m.init_(3)
    keys = init_keys(cfg, prng.PRNGKey(3))
    params = m.params()
    for name, (k, fan) in keys.items():
        v = params[name].numpy()
        if k.ndim == 1:
            want = prng.normal(k, v.shape)
        else:
            want = np.stack([prng.dense_init(k[l], v.shape[1:], fan)
                             for l in range(v.shape[0])])
        np.testing.assert_array_equal(_bits(v), _bits(want), err_msg=name)


def test_serve_and_driver_init_take_jax_init_params():
    serve = build_serve_setup(SPEC, ShapeCfg("prefill", 16, 2), smoke=True,
                              device="cpu")
    serve.model.init_(0)
    want = _jax_params(0)
    _assert_params_equal(serve.model.params(), want)
    setup = build_train_setup(SPEC, ShapeCfg("train", 32, 8),
                              TrainRun(seed=5), smoke=True, device="cpu")
    setup.init_state(prng.PRNGKey(0))       # JAX driver's key, any seed
    _assert_params_equal(setup.model.params(), want)
    setup.init_state()                      # default: PRNGKey(run.seed)
    _assert_params_equal(setup.model.params(), _jax_params(5))
