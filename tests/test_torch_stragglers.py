"""The port's straggler processes and rate-aware allocation
(`repro_torch/sim/stragglers.py`, `repro_torch/core/coding.py`) against the
JAX package's on the same seeds.

Tolerances and why: none.  Masks come from the port's copy of
`jax.random` with each threshold compared in f32 as JAX compares it, and
the allocation is float64 numpy in JAX's order, so every mask,
`sample_trace`, allocation and coverage is bit-equal, and every
validation error carries JAX's type and message.
"""
import jax
import numpy as np
import pytest

from repro.core import coding as jcoding
from repro.sim import stragglers as jst
from repro_torch.core import coding
from repro_torch.sim import stragglers as pst

SEEDS = (0, 1, 2, 3)
T = 201                                  # steps 0..200

# name -> (JAX process, port process) of N ranks
PROCESSES = {
    "iid": lambda m, N: m.IIDBernoulli(N, 0.1),
    "markov_p0.1_b8": lambda m, N: m.MarkovBursty(N, 0.1, 8.0),
    "markov_p0.25_b8": lambda m, N: m.MarkovBursty(N, 0.25, 8.0),
    "markov_p0.5_b8": lambda m, N: m.MarkovBursty(N, 0.5, 8.0),
    "hetero_linear": lambda m, N: m.HeterogeneousRates.linear(N, 0.3, 0.5),
    "hetero_two_class": lambda m, N: m.HeterogeneousRates.two_class(
        N, 0.6, 0.05, 0.3),
}


@pytest.mark.parametrize("N", (4, 7))
@pytest.mark.parametrize("name", sorted(PROCESSES))
def test_masks_and_traces_equal_jax(name, N):
    """sample_trace over steps 0..200 for seeds 0-3 bit for bit, a few
    single-step masks, and the marginal rates."""
    jp, pp = PROCESSES[name](jst, N), PROCESSES[name](pst, N)
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        want = jp.sample_trace(key, T)
        got = pp.sample_trace(seed, T)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        for t in (0, 63, T - 1):
            np.testing.assert_array_equal(pp.mask(seed, t).numpy(),
                                          np.asarray(jp.mask(key, t)))
            np.testing.assert_array_equal(pp.mask(seed, t).numpy(), got[t])
    np.testing.assert_array_equal(pp.rates(), jp.rates())
    if name.startswith("markov"):            # the chain really bursts
        assert 0 < got.mean() < 1


@pytest.mark.parametrize("p", (0.1, 0.25, 0.5))
def test_markov_burst_one_is_refused_as_in_jax(p):
    """mean_burst 1 leaves no room for the entry rate r = p/(1-p) below
    1 - q = 0: both packages refuse it with the same message."""
    with pytest.raises(ValueError) as want:
        jst.MarkovBursty(4, p, 1.0)
    with pytest.raises(ValueError) as got:
        pst.MarkovBursty(4, p, 1.0)
    assert str(got.value) == str(want.value)


def test_negative_steps_wrap_as_jax():
    """The lookback window of step 0 reaches steps -63..0, which JAX
    wraps through uint32; masks at negative steps too."""
    jp, pp = jst.MarkovBursty(5, 0.25, 4.0), pst.MarkovBursty(5, 0.25, 4.0)
    key = jax.random.PRNGKey(9)
    for t in (-1, -70, 2**20):
        np.testing.assert_array_equal(pp.mask(9, t).numpy(),
                                      np.asarray(jp.mask(key, t)))


@pytest.mark.parametrize("fmt", ("json", "csv"))
def test_traces_cross_between_packages(tmp_path, fmt):
    """A trace JAX writes the port replays, and the reverse: JSON through
    each package's `to_json`, CSV (a header row, then one row per step)
    from each package's masks; both replay the same masks, cyclic past
    the end, with the same rates."""
    key = jax.random.PRNGKey(42)
    masks_j = jst.MarkovBursty(4, 0.2, 6.0).sample_trace(key, 37)
    masks_p = pst.MarkovBursty(4, 0.2, 6.0).sample_trace(42, 37)
    np.testing.assert_array_equal(masks_p, masks_j)
    for writer, masks in (("jax", masks_j), ("port", masks_p)):
        path = tmp_path / f"{writer}.{fmt}"
        if fmt == "json":
            mod = jst if writer == "jax" else pst
            mod.TraceReplay.from_array(masks).to_json(path)
        else:
            np.savetxt(path, masks, fmt="%d", delimiter=",",
                       header="r0,r1,r2,r3", comments="")
        jt, pt = (jst.TraceReplay.from_file(path),
                  pst.TraceReplay.from_file(path))
        assert jt.masks == pt.masks and pt.num_devices == 4
        np.testing.assert_array_equal(pt.sample_trace(0, 80),
                                      jt.sample_trace(key, 80))
        np.testing.assert_array_equal(pt.rates(), jt.rates())
        proc = pst.get_straggler_process("trace", 4, trace=path)
        np.testing.assert_array_equal(proc.mask(5, 40).numpy(), masks[3])


ALLOC_CASES = [(seed, N, M, d) for seed, (N, M, d) in enumerate(
    ((4, 4, 2), (7, 7, 3), (8, 16, 2), (16, 16, 4), (5, 12, 2)))]


@pytest.mark.parametrize("exact_load", (False, True))
@pytest.mark.parametrize("case", ALLOC_CASES)
def test_rate_aware_allocation_equals_jax(case, exact_load):
    seed, N, M, d = case
    rng = np.random.default_rng(seed)
    for rates in (rng.uniform(0.3, 1.0, N), np.full(N, 0.8),
                  1.0 - np.linspace(0.05, 0.6, N)):
        if exact_load and (d * M) % N:
            with pytest.raises(ValueError) as want:
                jcoding.rate_aware_allocation(rates, M, d, exact_load=True)
            with pytest.raises(ValueError) as got:
                coding.rate_aware_allocation(rates, M, d, exact_load=True)
            assert str(got.value) == str(want.value)
            continue
        for slack in (1.0, 1.25):
            a = coding.rate_aware_allocation(rates, M, d, load_slack=slack,
                                             exact_load=exact_load)
            ja = jcoding.rate_aware_allocation(rates, M, d,
                                               load_slack=slack,
                                               exact_load=exact_load)
            np.testing.assert_array_equal(a.S, ja.S)
            assert a.S.dtype == ja.S.dtype
            if exact_load:
                assert (a.S.sum(1) == d * M // N).all()
            for alloc in (a, coding.cyclic_allocation(N, M, d)):
                cov = coding.expected_coverage(alloc, rates)
                jcov = jcoding.expected_coverage(
                    jcoding.Allocation(S=alloc.S), rates)
                np.testing.assert_array_equal(cov, jcov)


def _raises_alike(port_call, jax_call):
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(Exception) as got:
        port_call()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


VALIDATION = {
    "iid_p": lambda m: m.get_straggler_process("iid", 4, p=1.2),
    "markov_p": lambda m: m.get_straggler_process("markov", 4, p=-0.1),
    "markov_burst": lambda m: m.MarkovBursty(4, 0.2, 0.5),
    "hetero_spread": lambda m: m.get_straggler_process(
        "hetero", 8, 0.6, spread=0.8),
    "hetero_negative_spread": lambda m: m.get_straggler_process(
        "hetero", 8, 0.2, spread=-0.1),
    "hetero_length": lambda m: m.HeterogeneousRates(3, (0.1, 0.2)),
    "hetero_range": lambda m: m.HeterogeneousRates(2, (0.1, 1.0)),
    "trace_no_path": lambda m: m.get_straggler_process("trace", 3),
    "trace_empty": lambda m: m.TraceReplay(2, ()),
    "trace_row": lambda m: m.TraceReplay(2, ((1, 0), (1,))),
    "trace_entries": lambda m: m.TraceReplay(2, ((1, 2),)),
    "unknown": lambda m: m.get_straggler_process("gamma", 4, 0.1),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_errors_match_jax(case):
    _raises_alike(lambda: VALIDATION[case](pst),
                  lambda: VALIDATION[case](jst))


def test_trace_validation_matches_jax(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b\n1,0\n1\n")
    _raises_alike(lambda: pst.TraceReplay.from_csv(bad),
                  lambda: jst.TraceReplay.from_csv(bad))
    bad.write_text("1,0\nx,1\n")
    _raises_alike(lambda: pst.TraceReplay.from_csv(bad),
                  lambda: jst.TraceReplay.from_csv(bad))
    good = tmp_path / "t.json"
    pst.TraceReplay.from_array(np.eye(3)).to_json(good)
    _raises_alike(lambda: pst.get_straggler_process("trace", 5, trace=good),
                  lambda: jst.get_straggler_process("trace", 5, trace=good))
    for rates in ([0.5, 1.2], []):
        _raises_alike(
            lambda: coding.rate_aware_allocation(rates, 2, 2),
            lambda: jcoding.rate_aware_allocation(rates, 2, 2))
    _raises_alike(
        lambda: coding.expected_coverage(coding.cyclic_allocation(3, 3, 2),
                                         [0.5, 0.5]),
        lambda: jcoding.expected_coverage(jcoding.cyclic_allocation(3, 3, 2),
                                          [0.5, 0.5]))
