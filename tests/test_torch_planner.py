"""The port's simulation and planner (`repro_torch/sim/simulate.py`,
`sim/planner.py`, the `CodingPlan` replan hook) against JAX's.

  - `simulate_run`, `attach_times`, `time_to_target`: the same trace,
    times and byte ledger as JAX's (bit for bit: float64 numpy in the
    same order over the same masks);
  - the analytic stage (`enumerate_candidates`, `score_candidates`,
    `prune_candidates`, `expected_step_s`, `convergence_penalty`): the
    same candidates, order and scores, exactly;
  - `plan_search`: the same winner and ranking as JAX's on
    tests/test_planner.py's cases and on the driver's (markov, p 0.25,
    4 ranks); the confirmation's times to target within rtol 1e-5, and
    its final losses within 1e-6 of the target loss (the scale of the
    run's loss drop).  The port's reference loop rounds gamma*g + e twice
    and sums in a fixed order where XLA:CPU contracts an FMA and reorders
    (ROADMAP C12): a few f32 ulps per step, which the times to target
    (taken mid-drop) barely see (5e-8 relative seen), while the final
    loss sits at the task's floor, where the sign wire's decisions on
    near-zero accumulators part ways (0.00226 against 0.00205 seen, at a
    target of about 1.7e4);
  - its JSON has JAX's schema and keys, and the replan hook surfaces the
    ranking on a drift-triggered re-allocation.
"""
import json

import jax
import numpy as np
import pytest

from repro.core.collectives import SignWire as JSignWire
from repro.core.coding_state import CodingPlan as JCodingPlan
from repro.sim import (HeterogeneousRates as JHetero, IIDBernoulli as JIID,
                       LinkProfile as JLink, MarkovBursty as JMarkov,
                       StepTimer as JStepTimer, elastic_replan_hook as jhook,
                       enumerate_candidates as jenum, plan_search as jsearch,
                       simulate_run as jsim, time_to_target as jt2t)
from repro.sim.planner import expected_step_s as jexpected, \
    score_candidates as jscore
from repro_torch.core.coding_state import CodingPlan
from repro_torch.core.collectives import SignWire
from repro_torch.core.plan import PLAN_SCHEMA
from repro_torch.sim import (DEFAULT_COMPUTE, HeterogeneousRates,
                             IIDBernoulli, LinkProfile, MarkovBursty,
                             StepTimer, attach_times, elastic_replan_hook,
                             enumerate_candidates, plan_search,
                             prune_candidates, simulate_run, time_to_target)
from repro_torch.sim.planner import convergence_penalty, expected_step_s, \
    score_candidates

RTOL = {"sim_time_to_target_s": 1e-5, "sim_final_loss": 0.0}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("make", [
    lambda m: m.IIDBernoulli(num_devices=8, p=0.25),
    lambda m: m.MarkovBursty(num_devices=6, p=0.3, mean_burst=4.0)],
    ids=["iid", "markov"])
def test_simulate_run_ledger_equals_jax(seed, make):
    import repro.sim as jm
    import repro_torch.sim as pm
    n = 1 << 20
    timer = StepTimer(wire=SignWire(group_size=512), n=n)
    jtimer = JStepTimer(wire=JSignWire(group_size=512), n=n)
    sim = simulate_run(make(pm), timer, 50, seed)
    want = jsim(make(jm), jtimer, 50, jax.random.PRNGKey(seed))
    for f in ("step_time_s", "cum_time_s", "bytes_up", "bytes_down",
              "participants"):
        np.testing.assert_array_equal(getattr(sim, f), getattr(want, f))
    assert np.all(np.diff(sim.cum_time_s) > 0)
    np.testing.assert_array_equal(
        sim.bytes_up, sim.participants * SignWire(512).wire_bytes(n))
    at = sim.at_steps([0, 49])
    assert at == want.at_steps([0, 49])
    assert at["time_s"][1] == pytest.approx(sim.total_time_s)
    hist = attach_times({"step": [0, 10, 49], "loss": [3.0, 2.0, 1.0]}, sim)
    assert hist["time_s"] == sim.at_steps([0, 10, 49])["time_s"]


def test_time_to_target_interpolates():
    for args in (([0.0, 1.0, 2.0], [4.0, 2.0, 1.0], 3.0),
                 ([0.0, 1.0], [4.0, 2.0], 4.5), ([0.0, 1.0], [4.0, 2.0], 1.0),
                 ([0.0, 1.0, 3.0], [4.0, 4.0, 1.0], 4.0)):
        assert time_to_target(*args) == jt2t(*args)
    assert time_to_target([0.0, 1.0, 2.0], [4.0, 2.0, 1.0], 3.0) \
        == pytest.approx(0.5)
    assert time_to_target([0.0, 1.0], [4.0, 2.0], 1.0) is None


def _plans(cands):
    return [p.to_json() for p in cands]


def test_analytic_stage_equals_jax():
    """Grid, scores and order exactly; the brute-force optimum survives
    the pruning (JAX's test_bruteforce_top1_survives_analytic_pruning)."""
    N, n = 12, 1 << 20
    link, jlink = (LinkProfile(bandwidth_gbps=1.0),
                   JLink(bandwidth_gbps=1.0))
    kw = dict(p_slow=0.7, p_fast=0.05, slow_fraction=0.25)
    proc, jproc = HeterogeneousRates.two_class(N, **kw), \
        JHetero.two_class(N, **kw)
    q = np.asarray(proc.rates())
    np.testing.assert_array_equal(q, np.asarray(jproc.rates()))
    cands, jcands = enumerate_candidates(N, link=link, n=n), \
        jenum(N, link=jlink, n=n)
    assert _plans(cands) == _plans(jcands)
    got = score_candidates(cands, q, n, link, DEFAULT_COMPUTE)
    want = jscore(jcands, q, n, jlink, DEFAULT_COMPUTE)
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    brute = min((expected_step_s(p, n, link, DEFAULT_COMPUTE, proc, 0,
                                 T=128) * convergence_penalty(p, q, n),
                 p.to_json()) for p in cands)
    assert expected_step_s(cands[0], n, link, DEFAULT_COMPUTE, proc, 0,
                           T=128) == jexpected(jcands[0], n, jlink,
                                               DEFAULT_COMPUTE, jproc,
                                               jax.random.PRNGKey(0), T=128)
    kept = prune_candidates(cands, q, n, link, DEFAULT_COMPUTE, top_k=4)
    assert brute[1] in {c.plan.to_json() for c in kept}


def _same_search(got, want):
    g, w = got.to_dict(), want.to_dict()
    assert set(g) == set(w) and g["schema"] == w["schema"]
    assert (g["num_enumerated"], g["pruned_to"]) == \
        (w["num_enumerated"], w["pruned_to"])
    assert g["target_loss"] == pytest.approx(w["target_loss"], rel=1e-5)
    assert [c["plan"] for c in g["ranking"]] == \
        [c["plan"] for c in w["ranking"]]                # winner + order
    for a, b in zip(g["ranking"], w["ranking"]):
        for k in ("step_s", "penalty", "score", "confirmed"):
            assert a[k] == b[k], k
        for k in ("sim_time_to_target_s", "sim_final_loss"):
            assert (a[k] is None) == (b[k] is None), k
            if a[k] is not None:
                tol = 1e-6 * w["target_loss"] if k == "sim_final_loss" \
                    else 0.0
                assert a[k] == pytest.approx(b[k], rel=RTOL[k], abs=tol), k


def test_plan_search_equals_jax_and_is_deterministic():
    kw = dict(top_k=3, confirm_steps=40, trials=1, seed=3, dim=32,
              gamma=1e-4, record_every=10)
    two = dict(p_slow=0.6, p_fast=0.05, slow_fraction=0.25)
    r1 = plan_search(1 << 16, process=HeterogeneousRates.two_class(8, **two),
                     device="cpu", **kw)
    r2 = plan_search(1 << 16, process=HeterogeneousRates.two_class(8, **two),
                     device="cpu", **kw)
    assert r1.to_json() == r2.to_json()
    assert r1.best.confirmed and r1.num_enumerated >= r1.pruned_to == 3
    _same_search(r1, jsearch(1 << 16, process=JHetero.two_class(8, **two),
                             **kw))
    assert json.loads(r1.to_json())["schema"] == "repro.plan_search/v1"


def test_plan_search_rates_only_equals_jax():
    kw = dict(top_k=2, confirm_steps=30, trials=2, seed=1, dim=16,
              gamma=1e-4, record_every=10)
    rates = [1.0, 0.9, 0.6, 0.95]
    _same_search(plan_search(1 << 14, rates=rates, device="cpu", **kw),
                 jsearch(1 << 14, rates=rates, **kw))


def test_driver_plan_search_picks_jax_plan():
    """The driver's --plan auto search (markov, p 0.25, 4 ranks, priced at
    2**16, 120 confirmation steps) at a cut trial count, against JAX's."""
    kw = dict(confirm_steps=120, seed=0, trials=1, top_k=3)
    got = plan_search(1 << 16, process=MarkovBursty(4, p=0.25,
                                                    mean_burst=8.0),
                      device="cpu", **kw)
    want = jsearch(1 << 16, process=JMarkov(4, p=0.25, mean_burst=8.0), **kw)
    _same_search(got, want)


def test_replan_hook_surfaces_planner_ranking():
    hook = elastic_replan_hook(1 << 14)
    cp = CodingPlan.create(np.full(6, 0.8), 6, 2, drift_threshold=0.05,
                           replan_hook=hook)
    jcp = JCodingPlan.create(np.full(6, 0.8), 6, 2, drift_threshold=0.05,
                             replan_hook=jhook(1 << 14))
    q = np.array([0.2] * 3 + [0.9] * 3)
    _, info = cp.maybe_replan(q)
    _, jinfo = jcp.maybe_replan(q)
    assert info["reallocated"] and info == jinfo
    ranking = info["plan_ranking"]
    assert ranking and ranking[0]["plan"]["schema"] == PLAN_SCHEMA
    assert ranking[0]["score"] <= ranking[-1]["score"]
    _, quiet = cp.maybe_replan(q)                   # no drift: no ranking
    assert "plan_ranking" not in quiet
