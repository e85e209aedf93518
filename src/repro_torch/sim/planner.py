"""Auto-tuning planner over the (d, wire, k) configuration plane (port of
`repro.sim.planner`).

Three stages, as JAX's:

  enumerate  `enumerate_candidates` spans the PlanSpec grid: redundancy x
             compressor x sparsity budget (+ solve_k_budgets per-rank
             budgets when the link is heterogeneous).
  prune      `prune_candidates` scores every candidate analytically:
             StepTimer expected step time under the rate profile x a
             convergence-penalty proxy for compression aggressiveness /
             the coded coverage the allocation achieves at those rates.
  confirm    `plan_search` re-ranks the top-K survivors with short
             simulated linreg runs: the port's reference loop
             (`core.error_feedback`) driven by the straggler process's
             masks (seeds 1000 + seed + trial, JAX's PRNGKey(1000 + seed +
             s)), joined to the same trace's simulated wall clock
             (`simulate_run` + `attach_times`), ranked by time-to-target.

The analytic stage is float64 numpy in JAX's order, so its step seconds,
penalties and scores equal JAX's.  The confirmation's losses are not
JAX's bits: the port's loop rounds gamma*g + e twice and sums coded
gradients and dot products in a fixed order, where XLA:CPU contracts and
reorders (ROADMAP C12), so its times to target agree within a tolerance
(tests/test_torch_planner.py).

`elastic_replan_hook` re-ranks the candidate grid on every drift-triggered
re-allocation of the live coding plane (`CodingPlan.replan_hook`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import coding, compression as C, error_feedback as EF
from repro_torch.core.plan import PlanSpec
from .cost_model import (ComputeProfile, DEFAULT_COMPUTE, DEFAULT_LINK,
                         LinkProfile, StepTimer, solve_k_budgets)
from .simulate import attach_times, simulate_run, time_to_target
from .stragglers import HeterogeneousRates, StragglerProcess

__all__ = ["PlanCandidate", "PlanSearchResult", "enumerate_candidates",
           "plan_allocation", "plan_timer", "convergence_penalty",
           "analytic_step_s", "expected_step_s", "score_candidates",
           "prune_candidates", "plan_search", "toy_compressor",
           "elastic_replan_hook",
           "PLAN_SEARCH_SCHEMA"]

PLAN_SEARCH_SCHEMA = "repro.plan_search/v1"


# --------------------------------------------------------------------------
# candidate grid
# --------------------------------------------------------------------------

def enumerate_candidates(num_ranks: int, *,
                         d_options: Sequence[int] = (1, 2, 3),
                         k_options: Sequence[int] = (4, 8, 32),
                         allocations: Sequence[str] = ("uniform",),
                         group_size: int = 512, block_size: int = 256,
                         num_buckets: int = 1,
                         bucket_schedule: str = "pipelined",
                         backend: str = "auto",
                         link: Optional[LinkProfile] = None,
                         n: Optional[int] = None) -> List[PlanSpec]:
    """The fixed (d, wire, k) grid the planner searches.

    Every cell is a full PlanSpec (num_ranks bound), so the same list
    parameterizes the planner, the fig12 brute-force sweep, and — winner
    chosen — `TrainRun(plan=...)` directly.  When `link` carries per-rank
    bandwidths and `n` is given, a `solve_k_budgets` per-rank-budget cell
    joins the grid for each redundancy (the heterogeneous-uplink play).
    """
    plans: List[PlanSpec] = []
    for d in d_options:
        if d > num_ranks:
            continue
        for allocation in allocations:
            base = dict(d=d, allocation=allocation, group_size=group_size,
                        block_size=block_size, num_buckets=num_buckets,
                        bucket_schedule=bucket_schedule, backend=backend,
                        num_ranks=num_ranks)
            plans.append(PlanSpec(compressor="sign", **base))
            plans.append(PlanSpec(compressor="identity", **base))
            for k in k_options:
                if k > block_size:
                    continue
                plans.append(PlanSpec(compressor="block_topk",
                                      k_per_block=int(k), **base))
            if link is not None and link.rank_bandwidth_gbps and n \
                    and n % block_size == 0:
                ks = solve_k_budgets(n, num_ranks, link,
                                     block_size=block_size)
                if len(set(ks)) > 1:          # uniform budgets already in grid
                    plans.append(PlanSpec(compressor="block_topk",
                                          k_per_block=ks, **base))
    # dedupe preserving order (e.g. k_options collisions)
    seen, out = set(), []
    for p in plans:
        key = p.to_json()
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def plan_allocation(plan: PlanSpec, rates: np.ndarray) -> coding.Allocation:
    """The coded allocation this plan deploys at the given rate profile —
    the same uniform-cyclic / rate-aware / exact-load dispatch
    `launch.train.build_train_setup` performs."""
    m = plan.num_ranks or len(rates)
    if m <= 1:
        return coding.Allocation(S=np.ones((1, 1), np.int8))
    if plan.allocation == "uniform":
        return coding.cyclic_allocation(m, m, plan.d)
    return coding.rate_aware_allocation(
        np.asarray(rates, np.float64), m, plan.d,
        exact_load=(plan.allocation == "exact_load"))


def plan_timer(plan: PlanSpec, n: int, link: LinkProfile = DEFAULT_LINK,
               compute: ComputeProfile = DEFAULT_COMPUTE,
               pack_s: float = 0.0) -> StepTimer:
    """StepTimer priced on exactly the wire/schedule this plan ships —
    "the config priced is the config run" for the planner and fig12."""
    return StepTimer(wire=plan.wire(n, 1), n=n, link=link, compute=compute,
                     num_buckets=plan.num_buckets, overlap=plan.overlap,
                     pack_s=pack_s)


# --------------------------------------------------------------------------
# analytic pruning stage
# --------------------------------------------------------------------------

def convergence_penalty(plan: PlanSpec, rates: np.ndarray,
                        n: int) -> float:
    """Steps-to-target multiplier proxy for a plan's statistical cost.

    Two factors, both >= 1:

      compression  the biased-compressor contraction delta (Beznosikov et
                   al.): keep fraction f -> (1/f)^0.25.  The 1/4 exponent
                   tempers the worst-case 1/delta iteration blow-up because
                   error feedback empirically recovers most of it (fig2/
                   fig8: sign and top-k track dense per-iteration closely);
                   sign-bit keeps magnitude-of-mean info, charged a flat
                   1.2.
      coverage     1 / mean expected coverage of the coded allocation at
                   the rate profile: subsets with no surviving holder drop
                   out of the aggregate, scaling down the useful signal
                   (the redundancy-d axis of the paper's tradeoff).

    A proxy, not a convergence bound — it only needs to rank plans well
    enough that the simulated-confirmation stage sees the true optimum
    (tested against the brute-force ranking).
    """
    if plan.compressor == "identity":
        comp = 1.0
    elif plan.compressor == "sign":
        comp = 1.2
    elif plan.compressor == "block_topk":
        ks = plan.k_per_block
        k_mean = float(np.mean(ks)) if isinstance(ks, tuple) else float(ks)
        f = min(1.0, k_mean / plan.block_size)
        comp = (1.0 / f) ** 0.25
    elif plan.compressor == "topk":
        f = min(1.0, plan.topk_k / max(n, 1))
        comp = (1.0 / f) ** 0.25
    else:                                    # pragma: no cover (validated)
        raise ValueError(f"unknown compressor {plan.compressor!r}")
    cov = float(np.mean(coding.expected_coverage(
        plan_allocation(plan, rates), rates=np.asarray(rates, np.float64))))
    return comp / max(cov, 1e-3)


def analytic_step_s(plan: PlanSpec, n: int, link: LinkProfile,
                    compute: ComputeProfile, rates: np.ndarray) -> float:
    """Closed-form expected step seconds: one StepTimer evaluation on the
    FRACTIONAL rate profile (every rank with q_i > 0 participates at its
    rate).  Pessimistic on the compute max (the slowest sometimes-alive
    rank always bounds it) but monotone in the wire/link quantities the
    grid varies — the cheap stand-in the pruning stage sorts by."""
    t, _, _ = plan_timer(plan, n, link, compute).steps(
        np.asarray(rates, np.float64)[None, :])
    return float(t[0])


def expected_step_s(plan: PlanSpec, n: int, link: LinkProfile,
                    compute: ComputeProfile, process: StragglerProcess,
                    seed: int, T: int = 256) -> float:
    """Brute-force expected step seconds: mean StepTimer time over a
    sampled (T, N) mask trace of `seed` (JAX's `PRNGKey(seed)`) — the
    ground truth `analytic_step_s` approximates."""
    trace = process.sample_trace(seed, T)
    t, _, _ = plan_timer(plan, n, link, compute).steps(trace)
    return float(t.mean())


@dataclasses.dataclass
class PlanCandidate:
    """One scored cell of the search: analytic stage always filled,
    simulated-confirmation fields filled for survivors."""

    plan: PlanSpec
    step_s: float                       # analytic expected step seconds
    penalty: float                      # convergence-penalty proxy
    score: float                        # step_s * penalty (ranking key)
    confirmed: bool = False
    sim_time_to_target_s: Optional[float] = None
    sim_final_loss: Optional[float] = None

    def to_dict(self) -> Dict:
        return {"plan": self.plan.to_dict(), "step_s": self.step_s,
                "penalty": self.penalty, "score": self.score,
                "confirmed": self.confirmed,
                "sim_time_to_target_s": self.sim_time_to_target_s,
                "sim_final_loss": self.sim_final_loss}


def score_candidates(candidates: Sequence[PlanSpec], rates: np.ndarray,
                     n: int, link: LinkProfile,
                     compute: ComputeProfile) -> List[PlanCandidate]:
    """Analytic stage: score every candidate, return sorted best-first.
    Fully deterministic (ties broken on the serialized plan)."""
    out = []
    for p in candidates:
        step_s = analytic_step_s(p, n, link, compute, rates)
        pen = convergence_penalty(p, rates, n)
        out.append(PlanCandidate(plan=p, step_s=step_s, penalty=pen,
                                 score=step_s * pen))
    out.sort(key=lambda c: (c.score, c.plan.to_json()))
    return out


def prune_candidates(candidates: Sequence[PlanSpec], rates: np.ndarray,
                     n: int, link: LinkProfile = DEFAULT_LINK,
                     compute: ComputeProfile = DEFAULT_COMPUTE,
                     top_k: int = 4) -> List[PlanCandidate]:
    """Keep the `top_k` best analytic scores (the confirmation budget)."""
    return score_candidates(candidates, rates, n, link, compute)[:top_k]


# --------------------------------------------------------------------------
# simulated confirmation stage
# --------------------------------------------------------------------------

def toy_compressor(plan: PlanSpec, dim: int, n: int):
    """Map a plan's wire to the reference compressor driving the linreg
    confirmation dynamics at toy dimension `dim` (the fig8 convention:
    dynamics at toy scale, wire priced at production scale).  Block-top-K
    budgets keep their KEEP FRACTION: k_toy/block_toy = k/block (per-rank
    tuples use the mean budget — the dynamics see one fleet-average
    compressor; the per-rank byte asymmetry is priced by the timer)."""
    if plan.compressor == "identity":
        return None                                   # uncompressed step
    if plan.compressor == "sign":
        return C.GroupedSign()
    if plan.compressor == "block_topk":
        ks = plan.k_per_block
        k_mean = float(np.mean(ks)) if isinstance(ks, tuple) else float(ks)
        block_toy = dim if dim <= plan.block_size else plan.block_size
        while dim % block_toy:
            block_toy -= 1                            # largest divisor
        k_toy = max(1, int(round(block_toy * k_mean / plan.block_size)))
        return C.BlockTopK(k_per_block=k_toy, block_size=block_toy)
    if plan.compressor == "topk":
        f = min(1.0, plan.topk_k / max(n, 1))
        return C.TopK(k=max(1, int(round(dim * f))))
    raise ValueError(f"unknown compressor {plan.compressor!r}")


def _confirm_curve(plan: PlanSpec, process: StragglerProcess,
                   rates: np.ndarray, n: int, link: LinkProfile,
                   compute: ComputeProfile, *, T: int, trials: int,
                   seed: int, dim: int, gamma: float,
                   record_every: int, device) -> Dict[str, list]:
    """Short simulated linreg run: EF dynamics (the port's reference loop
    on `device`) under the process's masks, joined to the same trace's
    simulated wall clock.  Returns the trial-mean {step, loss, time_s}
    curve."""
    from repro_torch.data import tasks
    N = process.num_devices
    alloc = plan_allocation(plan, rates)
    W = coding.encode_weights(alloc, rates=np.asarray(rates, np.float64))
    comp = toy_compressor(plan, dim, n)
    timer = plan_timer(plan, n, link, compute)
    curves = []
    for s in range(trials):
        grad_fn, loss_fn, theta0, _ = tasks.linreg_task(
            seed=seed + s, num_subsets=alloc.num_subsets, dim=dim,
            device=device)
        mask_seed = 1000 + seed + s        # JAX's PRNGKey(1000 + seed + s)
        st = EF.EFState.init(theta0, N)
        trace = torch.from_numpy(process.sample_trace(mask_seed, T)
                                 ).to(theta0.device)
        hist = {"step": [], "loss": []}
        for t in range(T):
            mask = trace[t]
            if comp is None:
                st = EF.uncompressed_step(st, grad_fn, W, mask, gamma,
                                          step=t)
            else:
                st = EF.cocoef_step(st, grad_fn, W, mask, gamma, comp,
                                    step=t)
            if t % record_every == 0 or t == T - 1:
                hist["step"].append(t)
                hist["loss"].append(float(loss_fn(st.theta)))
        sim = simulate_run(process, timer, T, mask_seed)
        curves.append(attach_times(hist, sim))
    arr = lambda k: np.array([c[k] for c in curves])
    return {"step": curves[0]["step"], "loss": arr("loss").mean(0).tolist(),
            "time_s": arr("time_s").mean(0).tolist()}


@dataclasses.dataclass
class PlanSearchResult:
    """Ranked output of `plan_search` (best first by simulated
    time-to-target among the confirmed, then analytic score)."""

    candidates: List[PlanCandidate]
    target_loss: float
    num_enumerated: int
    pruned_to: int

    @property
    def best(self) -> PlanCandidate:
        return self.candidates[0]

    def to_dict(self) -> Dict:
        return {"schema": PLAN_SEARCH_SCHEMA,
                "target_loss": self.target_loss,
                "num_enumerated": self.num_enumerated,
                "pruned_to": self.pruned_to,
                "best": self.best.to_dict(),
                "ranking": [c.to_dict() for c in self.candidates]}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")


def plan_search(n: int, *, link: LinkProfile = DEFAULT_LINK,
                compute: ComputeProfile = DEFAULT_COMPUTE,
                process: Optional[StragglerProcess] = None,
                rates: Optional[Sequence[float]] = None,
                candidates: Optional[Sequence[PlanSpec]] = None,
                top_k: int = 4, confirm_steps: int = 300,
                trials: int = 2, seed: int = 0, dim: int = 256,
                gamma: float = 1e-5, record_every: int = 20,
                target_frac: float = 0.8, device="cuda"
                ) -> PlanSearchResult:
    """The full three-stage search.  Deterministic in `seed`; the
    confirmation runs on `device` (the reference loop is bit-exact across
    the port's devices, so the card and the CPU pick the same plan).

    Provide a `process` (simulated deployment) or live `rates` (e.g. a
    `RateEstimator` snapshot — a per-rank Bernoulli process is synthesized
    for the confirmation masks).  `n` is the production flat gradient size
    the wires are priced at; the confirmation dynamics run a linreg at toy
    `dim` under the SAME masks and the priced wall clock (fig8's
    convention).  Time-to-target uses the shared relative-drop convention
    (`target_frac` of the way from the common initial loss to the worst
    survivor's floor), so every survivor can reach it.
    """
    device = resolve_device(device)
    if process is None:
        if rates is None:
            raise ValueError("plan_search needs a StragglerProcess or a "
                             "rates vector")
        q = np.clip(np.asarray(rates, np.float64), 0.0, 1.0)
        process = HeterogeneousRates(
            num_devices=len(q),
            p_ranks=tuple(float(min(max(1.0 - r, 0.0), 0.999))
                          for r in q))
    q = np.asarray(process.rates(), np.float64)
    num_ranks = process.num_devices
    if candidates is None:
        candidates = enumerate_candidates(num_ranks, link=link, n=n)
    ranked = score_candidates(candidates, q, n, link, compute)
    survivors = ranked[:max(1, top_k)]

    curves = {}
    for cand in survivors:
        curves[id(cand)] = _confirm_curve(
            cand.plan, process, q, n, link, compute, T=confirm_steps,
            trials=trials, seed=seed, dim=dim, gamma=gamma,
            record_every=record_every, device=device)
    # shared drop target: frac of the way from the common initial loss to
    # the worst survivor's floor (every survivor reaches it)
    loss0 = max(c["loss"][0] for c in curves.values())
    floor = max(min(c["loss"]) for c in curves.values())
    target = loss0 - target_frac * (loss0 - floor)
    for cand in survivors:
        c = curves[id(cand)]
        cand.confirmed = True
        cand.sim_time_to_target_s = time_to_target(c["time_s"], c["loss"],
                                                   target)
        cand.sim_final_loss = float(c["loss"][-1])
    inf = float("inf")
    survivors.sort(key=lambda c: (
        c.sim_time_to_target_s if c.sim_time_to_target_s is not None
        else inf, c.score, c.plan.to_json()))
    return PlanSearchResult(candidates=survivors + ranked[len(survivors):],
                            target_loss=float(target),
                            num_enumerated=len(candidates),
                            pruned_to=len(survivors))


# --------------------------------------------------------------------------
# elastic integration
# --------------------------------------------------------------------------

def elastic_replan_hook(n: int, *, link: LinkProfile = DEFAULT_LINK,
                        compute: ComputeProfile = DEFAULT_COMPUTE,
                        candidates: Optional[Sequence[PlanSpec]] = None,
                        top_k: int = 4):
    """Pruning-stage re-invocation for the live coding plane.

    Returns a callable suitable for `CodingPlan.replan_hook`: on every
    drift-triggered re-allocation it re-scores the candidate grid under
    the NEW rate estimates and returns the analytic ranking as a list of
    dicts (JSON-able — it lands in the replan info record /
    MetricsLogger.log_replan).  Advisory by design: the running wire's
    payload buffers cannot change shape mid-run, so the ranking tells the
    operator (or a restart controller) what the planner would now pick.
    """
    def hook(rates: np.ndarray):
        q = np.asarray(rates, np.float64)
        cands = candidates
        if cands is None:
            cands = enumerate_candidates(len(q), link=link, n=n)
        ranked = prune_candidates(cands, q, n, link, compute, top_k=top_k)
        return [c.to_dict() for c in ranked]
    return hook
