"""The paper's Task B (`repro_torch.data.tasks.classification_task`, the
small CNN of Sec. V.B) against JAX's (`repro.data.tasks`) on the CPU, on
one torch thread, at JAX's defaults (M = 100 subsets of 16 images of 14 x
14, 512 test images asked for, 510 made), plus the registry's `get_arch`
and `all_cells`.

Tolerances and why:
  - X, Y, the test split, theta0 and the flat leaf layout (ravel_pytree's
    order: keys sorted, each leaf in C order, HWIO filters): bit for bit;
  - logits, loss_fn, the per-subset gradients and both metrics' losses:
    XLA:CPU and oneDNN sum the convolutions and the dense layer in other
    orders, so each is held within RTOL = 1e-5 of its largest magnitude
    (as tests/test_torch_reference.py holds linreg's gradients; measured
    1.6e-7 of the gradients' largest magnitude, 1.8e-7 of the metrics'
    losses); accuracies within 1e-6 (f32 means of the same 0/1 hits
    summed in other orders: 7.5e-9 seen);
  - max-pool ties on constant images (every interior window tied): the
    gradient within the same RTOL, so both route a tie alike;
  - one reference-loop step of each method on Task B's coded gradients
    (fig7's protocol: N = M = 100, d 2, p 0.6), both packages fed JAX's
    gradients and state, 3 steps: `unbiased_step` with StochasticSign
    equals JAX's bit for bit up to XLA:CPU's FMA of theta - gamma * s
    (ROADMAP C12; either form is accepted, the port's own is unfused);
    `cocoef_step` with GroupedSign (one group of D = 2698) within the
    group scale's C3 allowance (XLA_ULP = 6 ulp of the largest |acc|, a
    rank, summed over the N ranks) plus two roundings;
  - free-running, 10 steps of each method from each package's own
    gradients: F(theta) within RTOL (measured up to 1.7e-7 relative).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import one_thread
from repro.configs import all_cells as jall_cells, get_arch as jget_arch
from repro.core import coding as jcoding
from repro.core import compression as jcomp
from repro.core import error_feedback as JEF
from repro.data import tasks as jtasks
from repro_torch.configs import all_cells, get_arch
from repro_torch.core import coding, compression as comp
from repro_torch.core import error_feedback as EF, prng
from repro_torch.data import tasks
from repro_torch.kernels import ref

RTOL = 1e-5
XLA_ULP = 6
N = M = 100
D_FIG7, P_FIG7 = 2, 0.6
GAMMAS = {"cocoef": 3e-3, "unbiased": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def both():
    """JAX's Task B and the port's at JAX's defaults, built once."""
    return jtasks.classification_task(0), tasks.classification_task(
        0, device="cpu")


@pytest.fixture(scope="module")
def jgrad(both):
    return jax.jit(both[0][0])


def _i32(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _equal(a, b):
    np.testing.assert_array_equal(_i32(a), _i32(b))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _theta(jth, seed):
    """theta0 moved off its zero biases by a seeded step."""
    d = np.random.default_rng(seed).standard_normal(jth.shape)
    return (np.asarray(jth) + 0.05 * d).astype(np.float32)


def test_data_theta0_and_layout_bit_for_bit(both):
    (jgf, _, jth0, jex), (gf, _, th0, ex) = both
    jdata = {**inspect.getclosurevars(jgf).nonlocals,
             **inspect.getclosurevars(jex["test_metrics"]).nonlocals}
    _equal(ex["X"], jdata["Xj"])
    np.testing.assert_array_equal(ex["Y"].numpy(), np.asarray(jdata["Yj"]))
    _equal(ex["Xte"], jdata["Xte_j"])
    np.testing.assert_array_equal(ex["Yte"].numpy(),
                                  np.asarray(jdata["Yte_j"]))
    assert ex["X"].shape == (100, 16, 14, 14, 1)
    assert ex["Xte"].shape == (510, 14, 14, 1)
    assert th0.dtype == torch.float32 and th0.shape == (2698,)
    _equal(th0, jth0)
    model, jmodel = ex["model"], jex["model"]
    assert (model.img, model.dim) == (jmodel.img, jmodel.dim) == (14, 2698)
    x = _theta(jth0, 1)
    jleaves = jmodel.unravel(jnp.asarray(x))
    leaves = model.unravel(torch.from_numpy(x))
    assert list(leaves) == sorted(jleaves) == ["b1", "b2", "b3", "w1",
                                               "w2", "w3"]
    flat = torch.from_numpy(x)
    views = model.unravel(flat)
    for k in jleaves:
        assert leaves[k].shape == jleaves[k].shape
        _equal(leaves[k], jleaves[k])
        assert views[k]._base is flat                    # views of theta


@pytest.mark.parametrize("seed", [None, 1])
def test_logits_loss_grads_metrics_close_to_jax(both, jgrad, seed):
    (_, jlf, jth0, jex), (gf, lf, th0, ex) = both
    x = np.array(jth0) if seed is None else _theta(jth0, seed)
    th = torch.from_numpy(x)
    X = ex["X"][:8].reshape(-1, 14, 14, 1)
    got = tasks._cnn_logits(ex["model"].unravel(th), X)
    want = jtasks._cnn_logits(jex["model"].unravel(jnp.asarray(x)),
                              jnp.asarray(X.numpy()))
    _close(got, want)
    g = gf(th)
    assert g.shape == (100, 2698) and g.dtype == torch.float32
    _close(g, jgrad(jnp.asarray(x)))
    np.testing.assert_allclose(lf(th), float(jlf(jnp.asarray(x))),
                               rtol=RTOL)
    for name in ("test_metrics", "train_metrics"):
        (loss, acc), (jl, ja) = ex[name](th), jex[name](jnp.asarray(x))
        np.testing.assert_allclose(loss, float(jl), rtol=RTOL)
        assert abs(acc - float(ja)) <= 1e-6


def test_pool_ties_route_alike():
    """Constant images: every interior 2 x 2 window of both pools holds
    equal values, so the gradient shows which position each package
    routes a tie to."""
    _, _, jth0, jex = jtasks.classification_task(0, num_subsets=10,
                                                 test_samples=10)
    x = np.ones((16, 14, 14, 1), np.float32)
    x[8:] = -0.5
    y = np.arange(16) % 10
    th = _theta(jth0, 2)

    def jloss(t):
        logits = jtasks._cnn_logits(jex["model"].unravel(t), jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             axis=1))
    unravel, _ = tasks._unravel_of(14)

    def ploss(t):
        return tasks._xent(tasks._cnn_logits(unravel(t), torch.from_numpy(x)),
                           torch.from_numpy(y).long())
    want = jax.jit(jax.grad(jloss))(jnp.asarray(th))
    got = torch.func.grad(ploss)(torch.from_numpy(th))
    _close(got, want)


def _fma(a, b, c):
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float32)
                                    for v in (a, b, c)))
    return prng.fma_f32(a, b, c)


@pytest.mark.parametrize("method", ["cocoef", "unbiased"])
def test_step_fed_jax_gradients(both, jgrad, method):
    """fig7's trial 0 on Task B: the coded gradients W @ grad_f(theta)
    from JAX, fed with W = I to both packages' step (so neither sums the
    subsets), from JAX's state, 3 steps."""
    jgf, _, jth0, _ = both[0]
    alloc = jcoding.random_allocation(0, N, M, D_FIG7)
    W = jnp.asarray(jcoding.encode_weights(alloc, P_FIG7))
    coded = jax.jit(lambda th: W @ jgf(th))
    eye = np.eye(N, dtype=np.float32)
    gamma = GAMMAS[method]
    jc, pc = ((jcomp.GroupedSign(), comp.GroupedSign()) if method == "cocoef"
              else (jcomp.StochasticSign(), comp.StochasticSign()))
    jstate = JEF.EFState.init(jth0, N)
    for t in range(3):
        mask = np.asarray(jcoding.straggler_mask(jax.random.PRNGKey(1000),
                                                 t, N, P_FIG7))
        g = np.asarray(coded(jstate.theta))
        kw, pkw = ({}, {}) if method == "cocoef" else (
            {"key": jax.random.fold_in(jax.random.PRNGKey(2000), t)},
            {"key": prng.fold_in(prng.PRNGKey(2000), t)})
        jnew = getattr(JEF, f"{method}_step")(
            jstate, lambda th, g=jnp.asarray(g): g, jnp.asarray(eye), mask,
            gamma, jc, step=t, **kw)
        state = [np.array(x) for x in jstate]
        pnew = getattr(EF, f"{method}_step")(
            EF.EFState(*(torch.from_numpy(x.copy()) for x in state)),
            lambda th: torch.from_numpy(g), eye, torch.from_numpy(mask),
            gamma, pc, step=t, **pkw)
        th, e = state
        gam = np.float32(gamma)
        if method == "unbiased":
            keys = EF._per_device_keys(pkw["key"], t, N)
            q = np.stack([pc.apply(torch.from_numpy(g[i].copy()), keys[i])
                          .numpy() for i in range(N)])
            s = EF._masked_sum(torch.from_numpy(mask),
                               torch.from_numpy(q)).numpy()
            unfused = th - (gam * s).astype(np.float32)
            _equal(pnew.theta, unfused)
            assert any(np.array_equal(_i32(np.asarray(jnew.theta)), _i32(f))
                       for f in (unfused, _fma(-gam, s, th)))
            _equal(pnew.e, jnew.e)
        else:
            acc = (gam * g).astype(np.float32) + e
            tol = XLA_ULP * np.spacing(np.abs(acc).max(-1)).sum()
            for a, b in zip(pnew, jnew):
                a, b = a.numpy(), np.asarray(b)
                assert np.all(np.abs(a - b) <= tol + 2 * np.spacing(
                    np.abs(b)) + np.spacing(np.abs(gam * g)).sum(0))
        jstate = jnew


@pytest.mark.parametrize("method", ["cocoef", "unbiased"])
def test_free_running_loss_close_to_jax(both, method):
    (jgf, jlf, jth0, _), (gf, lf, th0, _) = both
    alloc = jcoding.random_allocation(0, N, M, D_FIG7)
    W = np.asarray(jcoding.encode_weights(alloc, P_FIG7))
    gamma = GAMMAS[method]
    jc, pc = ((jcomp.GroupedSign(), comp.GroupedSign()) if method == "cocoef"
              else (jcomp.StochasticSign(), comp.StochasticSign()))
    js, ps = JEF.EFState.init(jth0, N), EF.EFState.init(th0, N)
    for t in range(10):
        m = jcoding.straggler_mask(jax.random.PRNGKey(1000), t, N, P_FIG7)
        kw, pkw = ({}, {}) if method == "cocoef" else (
            {"key": jax.random.fold_in(jax.random.PRNGKey(2000), t)},
            {"key": prng.fold_in(prng.PRNGKey(2000), t)})
        js = getattr(JEF, f"{method}_step")(js, jgf, jnp.asarray(W), m,
                                            gamma, jc, step=t, **kw)
        ps = getattr(EF, f"{method}_step")(ps, gf, W,
                                           torch.from_numpy(np.array(m)),
                                           gamma, pc, step=t, **pkw)
    np.testing.assert_allclose(lf(ps.theta), float(jlf(js.theta)),
                               rtol=RTOL)
    assert lf(ps.theta) < lf(th0)                 # it trains


def test_grouped_sign_any_group_sums_in_a_fixed_tree():
    """GroupedSign over a group that is not a multiple of 32 (the
    quickstart's D = 100, Task B's D = 2698) takes its mean |x| from
    `ref.tree_sum`, which adds in the same order on every device."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        2698).astype(np.float32))
    got = comp.GroupedSign().apply(x)
    scale = ref.tree_sum(x.abs()) / 2698
    _equal(got, torch.where(x >= 0, scale, -scale))
    width, y = 4096, torch.nn.functional.pad(x.abs(), (0, 4096 - 2698))
    while width > 1:
        width //= 2
        y = y[:width] + y[width:]
    _equal(ref.tree_sum(x.abs()), y[0])


def test_get_arch_and_all_cells_equal_jax():
    cells, jcells = list(all_cells()), list(jall_cells())
    assert len(cells) == len(jcells) == 40
    for (a, s, cfg, why), (ja, js, jcfg, jwhy) in zip(cells, jcells):
        assert (a, s, why) == (ja, js, jwhy)
        assert (cfg is None) == (jcfg is None)
        if cfg is not None:
            assert (cfg.kind, cfg.seq_len, cfg.global_batch) == \
                (jcfg.kind, jcfg.seq_len, jcfg.global_batch)
    for aid in ("olmoe-1b-7b", "gemma2-2b"):
        assert get_arch(aid).arch_id == jget_arch(aid).arch_id == aid
    msgs = []
    for fn in (get_arch, jget_arch):
        with pytest.raises(KeyError) as ex:
            fn("nope")
        msgs.append(str(ex.value))
    assert msgs[0] == msgs[1]
