"""The port's deployment record, cost model and live coding plane
(`repro_torch/core/plan.py`, `repro_torch/sim/cost_model.py`,
`repro_torch/core/coding_state.py`, `repro_torch/data/pipeline.py::
elastic_train_batch`) against the JAX package's.

Tolerances and why: none.  PlanSpec files are the same JSON; the cost
model, the rate estimator and the replan controller are float64 numpy in
JAX's expressions and order, so StepTimer's seconds, the solved budgets,
the estimates, W and the allocations are equal to the float; the elastic
batch's tokens come from the port's copy of JAX's streams (bit-equal,
tests/test_torch_prng.py) and its weights are exact ones.
"""
import json

import jax
import numpy as np
import pytest

from repro.core import coding as jcoding
from repro.core import coding_state as jcs
from repro.core import collectives as jcol
from repro.core.plan import PlanSpec as JPlanSpec
from repro.data import pipeline as jpipeline
from repro.sim import cost_model as jcm
from repro_torch.core import coding, coding_state as cs, collectives as col
from repro_torch.core.plan import PlanSpec
from repro_torch.data import pipeline
from repro_torch.sim import cost_model as cm
from repro_torch.sim.stragglers import MarkovBursty

PLANS = {
    "default": {},
    "budgets": dict(compressor="block_topk", k_per_block=(8, 8, 4, 2),
                    block_size=64, num_ranks=4, allocation="rate_aware"),
    "topk": dict(d=3, compressor="topk", topk_k=128, value_dtype="bfloat16",
                 num_buckets=2, bucket_schedule="serial",
                 allocation="exact_load"),
    "identity": dict(compressor="identity", group_size=32, backend="pallas",
                     num_ranks=8),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_files_cross_between_packages(name, tmp_path):
    """A plan saved by either package loads in the other to an equal
    record: the same dict, the same JSON, the same wire bytes."""
    kw = PLANS[name]
    p, jp = PlanSpec(**kw), JPlanSpec(**kw)
    assert p.to_dict() == jp.to_dict()
    assert p.to_json(indent=2) == jp.to_json(indent=2)
    for save, load, want in ((p.save, JPlanSpec.load, jp),
                             (jp.save, PlanSpec.load, p)):
        path = tmp_path / "plan.json"
        save(str(path))
        assert load(str(path)) == want
    assert PlanSpec.from_json(jp.to_json()) == p
    assert p.pad_multiple == jp.pad_multiple and p.overlap == jp.overlap
    n, m = 1 << 14, p.num_ranks or 4
    np.testing.assert_array_equal(p.rank_wire_bytes(n, m),
                                  jp.rank_wire_bytes(n, m))
    assert p.wire(n, 4).wire_bytes(n) == jp.wire(n, 4).wire_bytes(n)


BAD_PLANS = {
    "d": dict(d=0),
    "d_over_ranks": dict(d=5, num_ranks=4),
    "allocation": dict(allocation="greedy"),
    "compressor": dict(compressor="randk"),
    "tuple_needs_block_topk": dict(k_per_block=(8, 4)),
    "one_k_per_rank": dict(compressor="block_topk", k_per_block=(8, 4),
                           num_ranks=4),
    "k_zero": dict(compressor="block_topk", k_per_block=(8, 0)),
    "k_float": dict(compressor="block_topk", k_per_block=(8, 4.5)),
    "k": dict(k_per_block=0),
    "buckets": dict(num_buckets=0),
    "schedule": dict(bucket_schedule="eager"),
    "backend": dict(backend="cuda"),
    "group": dict(group_size=0),
    "ranks": dict(num_ranks=0),
}


@pytest.mark.parametrize("name", sorted(BAD_PLANS))
def test_plan_validation_matches_jax(name):
    with pytest.raises(ValueError) as want:
        JPlanSpec(**BAD_PLANS[name])
    with pytest.raises(ValueError) as got:
        PlanSpec(**BAD_PLANS[name])
    assert str(got.value) == str(want.value)


def test_plan_json_validation_matches_jax():
    for obj in ({"schema": "repro.plan/v2"}, {"d": 2, "speed": 1}):
        with pytest.raises(ValueError) as want:
            JPlanSpec.from_dict(obj)
        with pytest.raises(ValueError) as got:
            PlanSpec.from_dict(obj)
        assert str(got.value) == str(want.value)


# ROADMAP Notes: the per-rank bytes and StepTimer step ms at n = 4,194,304
# coords per rank (default link and compute, no stragglers)
NOTES_N = 4_194_304
NOTES = {
    "sign g=512": (("sign", dict(group_size=512)), 557_056, 8.79),
    "topk 8/512 f32": (("block_topk", dict(k_per_block=8, block_size=512)),
                       425_984, 8.68),
    "topk 8/512 bf16": (("block_topk", dict(k_per_block=8, block_size=512,
                                            value_dtype="bfloat16")),
                        294_912, 8.58),
    "topk 32/512 f32": (("block_topk", dict(k_per_block=32,
                                            block_size=512)),
                        1_605_632, 9.63),
    "dense bf16": (("identity", dict(value_dtype="bfloat16")), 8_388_608,
                   15.05),
    "dense f32": (("identity", {}), 16_777_216, 21.76),
}


@pytest.mark.parametrize("name", sorted(NOTES))
def test_step_timer_reproduces_the_notes(name):
    (comp, kw), nbytes, ms = NOTES[name]
    wire = col.build_wire(comp, **kw)
    jwire = jcol.__dict__["SignWire" if comp == "sign" else
                          "SparseWire" if comp == "block_topk" else
                          "DenseWire"](**kw)
    assert wire.wire_bytes(NOTES_N) == jwire.wire_bytes(NOTES_N) == nbytes
    np.testing.assert_array_equal(wire.rank_wire_bytes(NOTES_N, 4),
                                  jwire.rank_wire_bytes(NOTES_N, 4))
    timer, jtimer = cm.StepTimer(wire, NOTES_N), jcm.StepTimer(jwire,
                                                               NOTES_N)
    assert round(timer.step_time(np.ones(4)) * 1e3, 2) == ms
    _same_timer(timer, jtimer)


def _same_timer(timer, jtimer, N=4, seed=0):
    """Every output of StepTimer.steps equal to JAX's to the float, over
    all-ones, all-straggler and seeded bursty masks."""
    trace = MarkovBursty(N, 0.3, 3.0).sample_trace(seed, 40)
    trace[0] = 1.0
    trace[1] = 0.0
    for a, b in zip(timer.steps(trace), jtimer.steps(trace)):
        np.testing.assert_array_equal(a, b)
    assert timer.bytes_up() == jtimer.bytes_up()
    assert timer.bytes_down() == jtimer.bytes_down()


@pytest.mark.parametrize("buckets,overlap,ms", ((1, False, 13.79),
                                                (4, False, 19.79),
                                                (4, True, 12.70)))
def test_step_timer_buckets_reproduce_the_notes(buckets, overlap, ms):
    """With a 5 ms pack stage: sign g=512 serial B=1, serial B=4 and
    pipelined B=4; and on a heterogeneous fleet with budgets, fan-in and
    speed factors, equal to JAX's."""
    kw = dict(num_buckets=buckets, overlap=overlap, pack_s=5e-3)
    timer = cm.StepTimer(col.SignWire(512), NOTES_N, **kw)
    jtimer = jcm.StepTimer(jcol.SignWire(512), NOTES_N, **kw)
    assert round(timer.step_time(np.ones(4)) * 1e3, 2) == ms
    _same_timer(timer, jtimer)
    link = dict(rank_bandwidth_gbps=(10.0, 10.0, 5.0, 2.5), server_fanin=2,
                latency_s=2e-3)
    comp = dict(grad_s=7e-3, speed_factors=(1.0, 1.5, 1.0, 3.0))
    wkw = dict(k_per_block=(8, 8, 4, 2), block_size=512,
               value_dtype="bfloat16")
    _same_timer(cm.StepTimer(col.SparseWire(**wkw), NOTES_N,
                             link=cm.LinkProfile(**link),
                             compute=cm.ComputeProfile(**comp),
                             phase2_itemsize=2, **kw),
                jcm.StepTimer(jcol.SparseWire(**wkw), NOTES_N,
                              link=jcm.LinkProfile(**link),
                              compute=jcm.ComputeProfile(**comp),
                              phase2_itemsize=2, **kw), seed=buckets)
    assert cm.ComputeProfile.from_flops(3e12).grad_s == \
        jcm.ComputeProfile.from_flops(3e12).grad_s


BUDGET_CASES = {
    "driver": (1 << 16, (10.0, 10.0, 5.0, 2.5), dict(block_size=64)),
    "notes": (NOTES_N, (10.0, 1.0, 40.0, 7.5), dict(block_size=512)),
    "bf16": (1 << 20, (3.0, 9.0, 0.5), dict(block_size=256,
                                            value_dtype="bfloat16",
                                            k_ref=16)),
    "deadline": (1 << 18, (2.0, 4.0, 8.0, 16.0), dict(block_size=128,
                                                      deadline_s=0.05,
                                                      k_min=2)),
}


@pytest.mark.parametrize("name", sorted(BUDGET_CASES))
def test_solve_k_budgets_equals_jax(name):
    n, bws, kw = BUDGET_CASES[name]
    got = cm.solve_k_budgets(n, len(bws), cm.LinkProfile(
        rank_bandwidth_gbps=bws), **kw)
    want = jcm.solve_k_budgets(n, len(bws), jcm.LinkProfile(
        rank_bandwidth_gbps=bws), **kw)
    assert got == want and all(type(k) is int for k in got)
    if name == "driver":
        assert got == (8, 8, 3, 1)


def test_cost_model_validation_matches_jax():
    for call in (lambda m: m.LinkProfile(bandwidth_gbps=0),
                 lambda m: m.LinkProfile(rank_bandwidth_gbps=(1.0, -1.0)),
                 lambda m: m.solve_k_budgets(100, 2, m.LinkProfile(),
                                             block_size=64),
                 lambda m: m.solve_k_budgets(128, 2, m.LinkProfile(),
                                             block_size=64, deadline_s=1e-4),
                 lambda m: m.LinkProfile(rank_bandwidth_gbps=(1.0, 2.0)
                                         ).up_bandwidths(3),
                 lambda m: m.ComputeProfile(speed_factors=(1.0,)
                                            ).rank_seconds(2)):
        with pytest.raises(ValueError) as want:
            call(jcm)
        with pytest.raises(ValueError) as got:
            call(cm)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("exact_load", (False, True))
@pytest.mark.parametrize("N,M,d", ((4, 4, 2), (8, 8, 3), (6, 12, 2)))
def test_coding_plane_equals_jax(N, M, d, exact_load):
    """RateEstimator and CodingPlan.maybe_replan over 60 seeded bursty
    masks: rates, W, epoch, drift and allocation equal JAX's at every
    tick; then a resize, and the rates=None tick."""
    est, jest = cs.RateEstimator(N, alpha=0.2), jcs.RateEstimator(N,
                                                                  alpha=0.2)
    q0 = 1.0 - np.linspace(0.05, 0.4, N)
    plan = cs.CodingPlan.create(q0, M, d, drift_threshold=0.15,
                                exact_load=exact_load)
    jplan = jcs.CodingPlan.create(q0, M, d, drift_threshold=0.15,
                                  exact_load=exact_load)
    np.testing.assert_array_equal(plan.allocation.S, jplan.allocation.S)
    masks = MarkovBursty(N, 0.3, 4.0).sample_trace(N + M, 60)
    replans = 0
    for m in masks:
        np.testing.assert_array_equal(est.update(m), jest.update(m))
        st, info = plan.maybe_replan(est.rates)
        jst_, jinfo = jplan.maybe_replan(jest.rates)
        assert info == jinfo
        np.testing.assert_array_equal(st.W, np.asarray(jst_.W))
        np.testing.assert_array_equal(st.rates_estimate,
                                      np.asarray(jst_.rates_estimate))
        assert st.epoch == int(jst_.epoch)
        np.testing.assert_array_equal(plan.allocation.S, jplan.allocation.S)
        replans += info["reallocated"]
    assert replans > 0
    est.resize(N + 2, survivors=[N - 1, 0])
    jest.resize(N + 2, survivors=[N - 1, 0])
    np.testing.assert_array_equal(est.rates, jest.rates)
    np.testing.assert_array_equal(est.steps_seen, jest.steps_seen)
    plan.resize(est.rates, N + 2)
    jplan.resize(jest.rates, N + 2)
    np.testing.assert_array_equal(plan.allocation.S, jplan.allocation.S)
    st, info = cs.maybe_replan(plan, None)
    jst_, jinfo = jcs.maybe_replan(jplan, None)
    assert info == jinfo and st.epoch == int(jst_.epoch)
    np.testing.assert_array_equal(st.W, np.asarray(jst_.W))


def test_pinned_plane_gives_the_static_weights():
    """With the estimate pinned to the oracle rates (no clip) the plane's W
    is the static encode_weights bit for bit, as in JAX."""
    rates = 1.0 - np.linspace(0.05, 0.15, 4)
    alloc = coding.cyclic_allocation(4, 4, 2)
    plan = cs.CodingPlan.create(rates, 4, 2, allocation=alloc)
    np.testing.assert_array_equal(plan.state(clip=False).W,
                                  coding.encode_weights(alloc, rates=rates))
    assert plan.state().W.dtype == np.float32
    for bad in (dict(alpha=0.0), dict(prior=1.5)):
        with pytest.raises(ValueError) as want:
            jcs.RateEstimator(4, **bad)
        with pytest.raises(ValueError) as got:
            cs.RateEstimator(4, **bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,step", ((0, 0), (0, 5), (3, 17)))
def test_elastic_train_batch_equals_jax(seed, step):
    """Tokens, weights (exact ones) and subset ids of a re-allocated
    (exact-load) placement equal JAX's; a placement of unequal loads is
    refused with JAX's message."""
    rates = [0.95, 0.9, 0.7, 0.6]
    alloc = coding.rate_aware_allocation(rates, 4, 2, exact_load=True)
    jalloc = jcoding.rate_aware_allocation(rates, 4, 2, exact_load=True)
    got = pipeline.elastic_train_batch(seed, step, alloc, 3, 16, 256000)
    want = jpipeline.elastic_train_batch(jax.random.PRNGKey(seed), step,
                                         jalloc, 3, 16, 256000)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].dtype.is_floating_point is False
    toks, _ = pipeline.coded_train_batch(seed, step, alloc,
                                         np.ones((4, 4), np.float32), 3, 16,
                                         256000)
    np.testing.assert_array_equal(toks.numpy(), got[0].numpy())
    uneven = coding.rate_aware_allocation(rates, 4, 2)
    with pytest.raises(ValueError) as w:
        jpipeline.elastic_train_batch(jax.random.PRNGKey(0), 0,
                                      jcoding.Allocation(S=uneven.S), 3, 16,
                                      256)
    with pytest.raises(ValueError) as g:
        pipeline.elastic_train_batch(0, 0, uneven, 3, 16, 256)
    assert str(g.value) == str(w.value)
    assert json.dumps(got[2].tolist())
