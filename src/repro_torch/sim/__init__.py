"""Cluster simulation (port of `repro.sim`): the straggler processes that
draw the per-step participation masks, the wall-clock cost model of one
coded step, `simulate_run` (mask trace -> simulated timeline) and the
planner (`plan_search`, the driver's --plan auto)."""
from .cost_model import (DEFAULT_COMPUTE, DEFAULT_LINK, ComputeProfile,
                         LinkProfile, StepTimer, solve_k_budgets)
from .planner import (PlanCandidate, PlanSearchResult, elastic_replan_hook,
                      enumerate_candidates, plan_allocation, plan_search,
                      plan_timer, prune_candidates)
from .simulate import SimRun, attach_times, simulate_run, time_to_target
from .stragglers import (STRAGGLER_PROCESSES, HeterogeneousRates,
                         IIDBernoulli, MarkovBursty, StragglerProcess,
                         TraceReplay, get_straggler_process)

__all__ = [
    "StragglerProcess", "IIDBernoulli", "MarkovBursty", "HeterogeneousRates",
    "TraceReplay", "get_straggler_process", "STRAGGLER_PROCESSES",
    "LinkProfile", "ComputeProfile", "StepTimer", "solve_k_budgets",
    "DEFAULT_LINK", "DEFAULT_COMPUTE", "SimRun", "simulate_run",
    "attach_times", "time_to_target",
    "PlanCandidate", "PlanSearchResult", "enumerate_candidates",
    "plan_allocation", "plan_timer", "prune_candidates", "plan_search",
    "elastic_replan_hook",
]
