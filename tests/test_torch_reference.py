"""The port's reference loop of Algorithm 1 against JAX's (`repro_torch`
`core.compression`, `core.error_feedback`, `data.tasks`, `core.prng`
split/permutation/choice and `core.coding`'s masks and allocations).

Tolerances and why:
  - compressors on the same numpy inputs: Identity, TopK (`lax.top_k`'s
    tie order, C1), BlockTopK (JAX's own tie set, C8), StochasticSign and
    RandK (JAX's bits from the same keys), the sparse and dense wires'
    roundtrips: bit for bit.  GroupedSign and the sign wire: signs exact,
    scales within XLA_ULP = 6 ulp (the group mean's order, C3).
  - keys, permutations, choices, linreg's Z, y and theta0, masks and
    allocations: bit for bit.
  - one step of each of the five steps, fed JAX's coded gradients and
    JAX's state (3 steps of linreg each): inside `jax.jit` XLA:CPU may
    contract gamma*g + e, and theta - gamma*s, h + alpha*q, H + alpha*s,
    into FMAs (ROADMAP C12; measured on this CPU: block top-K's accumulate
    and every baseline's server update), where the port rounds twice.  So
    each JAX result must equal, bit for bit, the port's pieces (its
    compressor, `_masked_sum`) composed with those operations either
    unfused or fused, and the port's step must equal its own pieces
    unfused.  Identity's cocoef and every coco step are measured exact
    against JAX outright.  Sign: within 6 ulp of the group scales per
    rank (C3), summed over the ranks, plus one rounding.
  - 20 free-running linreg steps (sign, block top-K, identity wires):
    JAX sums Z @ theta in XLA's order, the port in a fixed tree
    (`data.tasks`); theta within 2e-6 (measured 4.8e-7, two ulps of
    |theta| ~ 3), e within 1e-7, the loss within 1e-4 relative.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coding as jcoding
from repro.core import collectives as jcoll
from repro.core import compression as jcomp
from repro.core import error_feedback as JEF
from repro.data import tasks as jtasks
from repro_torch.core import coding, collectives as coll, compression as comp
from repro_torch.core import error_feedback as EF, prng
from repro_torch.data import tasks

XLA_ULP = 6
N, D, GAMMA, P = 4, 1024, 2e-6, 0.25


def _i32(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _equal(a, b):
    np.testing.assert_array_equal(_i32(a), _i32(b))


def _inputs(seed, n=1024):
    """Mixed-scale normals with ties planted: 9 equal magnitudes of mixed
    sign in block 1 of 64, three at the top of block 2 of 64 behind a
    smaller pair, a zero block."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.repeat(np.exp(rng.uniform(-5, 3, n // 64)),
                                           64)
    x[64:73] = np.where(np.arange(9) % 2, -2.5, 2.5)
    x[128:192] *= 1e-3
    x[128:130] = 3.0
    x[150:153] = -5.0
    x[256:320] = 0.0
    return x.astype(np.float32)


PAIRS = {
    "identity": (jcomp.Identity(), comp.Identity()),
    "topk": (jcomp.TopK(37), comp.TopK(37)),
    "block_topk": (jcomp.BlockTopK(4, 64), comp.BlockTopK(4, 64)),
    "block_topk_k3": (jcomp.BlockTopK(3, 64), comp.BlockTopK(3, 64)),
    "stochastic_sign": (jcomp.StochasticSign(32), comp.StochasticSign(32)),
    "stochastic_sign_all": (jcomp.StochasticSign(), comp.StochasticSign()),
    "randk": (jcomp.RandK(100), comp.RandK(100)),
    "wire_sparse": (jcomp.WireCompressor(jcoll.SparseWire(4, 64)),
                    comp.WireCompressor(coll.SparseWire(4, 64))),
    "wire_dense_bf16": (jcomp.WireCompressor(jcoll.DenseWire("bfloat16")),
                        comp.WireCompressor(coll.DenseWire("bfloat16"))),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_compressor_equals_jax(name):
    jc, pc = PAIRS[name]
    assert pc.unbiased == jc.unbiased
    for seed in (0, 1):
        x = _inputs(seed)
        key = jax.random.PRNGKey(seed + 7)
        want = np.asarray(jc.apply(jnp.asarray(x), key if jc.unbiased
                                   else None))
        got = pc.apply(torch.from_numpy(x.copy()),
                       prng.PRNGKey(seed + 7) if pc.unbiased else None)
        assert got.dtype == torch.float32 and got.shape == (1024,)
        _equal(got, want)


@pytest.mark.parametrize("group", [32, 512, -1])
def test_grouped_sign_within_c3(group):
    for jc, pc in ((jcomp.GroupedSign(group), comp.GroupedSign(group)),
                   (jcomp.WireCompressor(jcoll.SignWire(max(group, 32))),
                    comp.WireCompressor(coll.SignWire(max(group, 32))))):
        x = _inputs(3)
        want = np.asarray(jc.apply(jnp.asarray(x)))
        got = pc.apply(torch.from_numpy(x.copy())).numpy()
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
        du = np.abs(_i32(np.abs(got)).astype(np.int64)
                    - _i32(np.abs(want)))
        assert du.max() <= XLA_ULP


def test_block_topk_keeps_jax_tie_set_not_lax_top_k():
    """|x| = [3, 3, 5, ...] with k = 2: JAX's BlockTopK keeps positions
    {0, 1} (the first k at or above the k-th largest), not {0, 2} (C8)."""
    x = np.zeros(64, np.float32)
    x[:3] = [3.0, -3.0, 5.0]
    got = comp.BlockTopK(2, 64).apply(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.nonzero(got)[0], [0, 1])
    _equal(got, jcomp.BlockTopK(2, 64).apply(jnp.asarray(x)))


def test_delta_wire_bits_and_registry_equal_jax():
    kw = {"identity": {}, "sign": {"group_size": 32},
          "grouped_sign": {"group_size": 64}, "topk": {"k": 10},
          "block_topk": {"k_per_block": 8, "block_size": 256},
          "stochastic_sign": {"group_size": 128}, "randk": {"k": 5}}
    for name, k in kw.items():
        jc, pc = jcomp.get_compressor(name, **k), comp.get_compressor(
            name, **k)
        assert type(pc).__name__ == type(jc).__name__
        for n in (1024, 4096):
            assert pc.wire_bits(n) == jc.wire_bits(n)
            if not jc.unbiased:
                assert pc.delta(n) == jc.delta(n)
    for w, jw in ((coll.SignWire(512), jcoll.SignWire(512)),
                  (coll.SparseWire(8, 256), jcoll.SparseWire(8, 256))):
        assert comp.WireCompressor(w).wire_bits(1 << 22) == \
            jcomp.WireCompressor(jw).wire_bits(1 << 22)
    with pytest.raises(KeyError):
        comp.get_compressor("nope")
    for c in (comp.GroupedSign(32), comp.BlockTopK(8, 256), comp.TopK(64),
              comp.RandK(64), comp.Identity()):
        w, jw = coll.wire_for_compressor(c, 4096, 4), \
            jcoll.wire_for_compressor(
                getattr(jcomp, type(c).__name__)(
                    **{f: getattr(c, f) for f in
                       ("group_size", "k_per_block", "block_size", "k")
                       if hasattr(c, f)}), 4096, 4)
        assert type(w).__name__ == type(jw).__name__
        assert w.wire_bytes(4096) == jw.wire_bytes(4096)


@pytest.mark.parametrize("seed", [0, 9, 2**32 - 1])
def test_split_permutation_choice_equal_jax(seed):
    k, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for num in (1, 2, 5):
        _equal(prng.split(pk, num), jax.random.split(k, num))
    for n in (1, 2, 100, 1000, 5000, 70_000):
        a = np.asarray(jax.random.permutation(k, n))
        b = prng.permutation(pk, n)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
        m = min(n, 33)
        np.testing.assert_array_equal(
            prng.choice(pk, n, (m,)),
            np.asarray(jax.random.choice(k, n, (m,), replace=False)))


def test_coding_masks_allocations_equal_jax():
    key = jax.random.PRNGKey(1000)
    for t in range(6):
        _equal(coding.straggler_mask(prng.PRNGKey(1000), t, 7, 0.3),
               jcoding.straggler_mask(key, t, 7, 0.3))
    for seed, (n_dev, m, d) in itertools.product((0, 4), ((10, 10, 3),
                                                         (6, 9, 2))):
        a = coding.random_allocation(seed, n_dev, m, d)
        ja = jcoding.random_allocation(seed, n_dev, m, d)
        np.testing.assert_array_equal(a.S, ja.S)
        assert coding.redundancy_theta(a) == jcoding.redundancy_theta(ja)


def test_linreg_task_equals_jax():
    gf, lf, th0, ex = tasks.linreg_task(3, 8, 100, device="cpu")
    jgf, jlf, jth0, jex = jtasks.linreg_task(3, 8, 100)
    _equal(th0, jth0)
    _equal(ex["Z"], jex["Z"])
    _equal(ex["y"], jex["y"])
    g, jg = gf(th0).numpy(), np.asarray(jgf(jth0))
    assert g.shape == (8, 100)
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(lf(th0), float(jlf(jth0)), rtol=1e-5)


# ---- the five steps, fed JAX's coded gradients ----------------------------

def _fma(a, b, c):
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float32)
                                    for v in (a, b, c)))
    return prng.fma_f32(a, b, c)


def _rows(pc, x, keys):
    return np.stack([pc.apply(torch.from_numpy(x[i].copy()),
                              None if keys is None else keys[i]).numpy()
                     for i in range(x.shape[0])])


def _msum(mask, c):
    return EF._masked_sum(torch.from_numpy(mask),
                          torch.from_numpy(c)).numpy()


def _composed(kind, pc, state, g, mask, keys, fused):
    """The step from the port's pieces, with the operations in `fused`
    ("acc", "theta", "h", "H") as single-rounding FMAs."""
    gam = np.float32(GAMMA)
    m = mask[:, None] > 0
    if kind in ("cocoef", "coco"):
        th, e = state
        if kind == "coco":
            acc = (gam * g).astype(np.float32)
        else:
            acc = (_fma(gam, g, e) if "acc" in fused
                   else (gam * g).astype(np.float32) + e)
        c = _rows(pc, acc, keys)
        th = th - _msum(mask, c)
        return (th, np.where(m, acc - c, e) if kind == "cocoef" else e)

    def upd(th, s):          # th - gamma * s
        return _fma(-gam, s, th) if "theta" in fused else th - gam * s
    if kind == "uncompressed":
        th, e = state
        return upd(th, _msum(mask, g)), e
    if kind == "unbiased":
        th, e = state
        return upd(th, _msum(mask, _rows(pc, g, keys))), e
    th, h, H = state
    a = np.float32(0.1)
    q = _rows(pc, g - h, keys)
    qs = _msum(mask, q)
    h_new = np.where(m, _fma(a, q, h) if "h" in fused else h + a * q, h)
    H_new = _fma(a, qs, H) if "H" in fused else H + a * qs
    return upd(th, H + qs), h_new, H_new


STEPS = {"cocoef": ("cocoef_step", EF.EFState, ("acc",)),
         "coco": ("coco_step", EF.EFState, ()),
         "unbiased": ("unbiased_step", EF.EFState, ("theta",)),
         "unbiased_diff": ("unbiased_diff_step", EF.DiffState,
                           ("theta", "h", "H")),
         "uncompressed": ("uncompressed_step", EF.EFState, ("theta",))}
COMPRESSORS = {"identity": PAIRS["identity"],
               "block_topk": PAIRS["block_topk"],
               "sign": (jcomp.GroupedSign(32), comp.GroupedSign(32)),
               "stochastic_sign": PAIRS["stochastic_sign"],
               "randk": PAIRS["randk"]}
CASES = [(k, c) for k in STEPS for c in COMPRESSORS
         if (k in ("unbiased", "unbiased_diff")
             or c not in ("stochastic_sign", "randk"))
         and (k != "uncompressed" or c == "identity")]
EXACT = {("cocoef", "identity")} | {("coco", c) for c in COMPRESSORS
                                    if c != "sign"}


@pytest.fixture(scope="module")
def linreg():
    gf, lf, th0, _ = jtasks.linreg_task(0, N, D)
    W = np.asarray(jcoding.encode_weights(jcoding.cyclic_allocation(N, N, 2),
                                          P))
    return gf, th0, W, jax.jit(lambda th: jnp.asarray(W) @ gf(th))


@pytest.mark.parametrize("kind,cname", CASES)
def test_step_fed_jax_gradients_equals_jax(linreg, kind, cname):
    gf, th0, W, coded = linreg
    jfn, pstate, fusable = STEPS[kind]
    jc, pc = COMPRESSORS[cname]
    keyed = jc.unbiased
    jstate = getattr(JEF, pstate.__name__).init(th0, N)
    eye = np.eye(N, dtype=np.float32)
    for t in range(3):
        mask = np.array(jcoding.straggler_mask(jax.random.PRNGKey(1000),
                                                 t, N, P))
        g = np.asarray(coded(jstate.theta))
        args = (() if kind == "uncompressed" else (jc,))
        kw = {} if kind == "uncompressed" else {
            "key": jax.random.PRNGKey(5) if keyed else None}
        jnew = getattr(JEF, jfn)(jstate, gf, jnp.asarray(W), mask, GAMMA,
                                 *args, step=t, **kw)
        state = [np.array(x) for x in jstate]
        pkw = {} if kind == "uncompressed" else {
            "key": prng.PRNGKey(5) if keyed else None}
        pnew = getattr(EF, jfn)(pstate(*(torch.from_numpy(x.copy())
                                         for x in state)),
                                lambda th: torch.from_numpy(g), eye,
                                torch.from_numpy(mask), GAMMA,
                                *(() if kind == "uncompressed" else (pc,)),
                                step=t, **pkw)
        keys = (prng.split(prng.fold_in(prng.PRNGKey(5), t), N)
                if keyed else None)
        own = _composed(kind, pc, state, g, mask, keys, ())
        for a, b in zip(pnew, own):
            _equal(a, b)
        jn = [np.asarray(x) for x in jnew]
        if (kind, cname) in EXACT:
            for a, b in zip(pnew, jn):
                _equal(a, b)
        elif cname != "sign":
            forms = [_composed(kind, pc, state, g, mask, keys, f)
                     for r in range(len(fusable) + 1)
                     for f in itertools.combinations(fusable, r)]
            assert any(all(np.array_equal(_i32(a), _i32(b))
                           for a, b in zip(f, jn)) for f in forms), \
                f"{kind}/{cname} step {t}: no FMA form matches JAX"
        else:                       # C3: the largest |x| bounds a scale
            x = {"cocoef": np.float32(GAMMA) * g + state[-1],
                 "coco": np.float32(GAMMA) * g,
                 "unbiased_diff": g - state[1]}.get(kind, g)
            tol = XLA_ULP * np.spacing(np.float32(np.abs(x).max())) * N
            for a, b in zip(pnew, jn):
                a = a.numpy()
                assert np.all(np.abs(a - b) <= tol + 2 * np.spacing(
                    np.abs(b)) + np.spacing(np.float32(GAMMA) * np.abs(g)
                                            ).sum(0))
        jstate = jnew


@pytest.mark.parametrize("wire", ["sign", "block_topk", "identity"])
def test_free_running_linreg_close_to_jax(wire):
    """20 steps of the parity gate's reference loop in each package, each
    from its own stage 1 (tolerances in the module docstring)."""
    jw = {"sign": jcoll.SignWire(32), "block_topk": jcoll.SparseWire(4, 64),
          "identity": jcoll.DenseWire()}[wire]
    pw = {"sign": coll.SignWire(32), "block_topk": coll.SparseWire(4, 64),
          "identity": coll.DenseWire()}[wire]
    gf, lf, th0, _ = jtasks.linreg_task(0, N, D)
    pgf, plf, pth0, _ = tasks.linreg_task(0, N, D, device="cpu")
    W = np.asarray(jcoding.encode_weights(
        jcoding.cyclic_allocation(N, N, 2), P))
    js, ps = JEF.EFState.init(th0, N), EF.EFState.init(pth0, N)
    key = jax.random.PRNGKey(1000)
    for t in range(20):
        m = jcoding.straggler_mask(key, t, N, P)
        js = JEF.cocoef_step(js, gf, jnp.asarray(W), m, GAMMA,
                             jcomp.WireCompressor(jw), step=t)
        ps = EF.cocoef_step(ps, pgf, W, torch.from_numpy(np.array(m)),
                            GAMMA, comp.WireCompressor(pw), step=t)
        assert np.abs(ps.theta.numpy() - np.asarray(js.theta)).max() <= 2e-6
        assert np.abs(ps.e.numpy() - np.asarray(js.e)).max() <= 1e-7
    np.testing.assert_allclose(plf(ps.theta), float(lf(js.theta)),
                               rtol=1e-4)
    assert plf(ps.theta) < plf(pth0) / 10          # it trains
