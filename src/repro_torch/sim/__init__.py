"""Cluster simulation (port of `repro.sim`, as far as it is ported): the
straggler processes that draw the per-step participation masks, and the
wall-clock cost model of one coded step.  The planner (`plan_search`) and
`simulate_run` are not ported yet (ROADMAP A7)."""
from .cost_model import (DEFAULT_COMPUTE, DEFAULT_LINK, ComputeProfile,
                         LinkProfile, StepTimer, solve_k_budgets)
from .stragglers import (STRAGGLER_PROCESSES, HeterogeneousRates,
                         IIDBernoulli, MarkovBursty, StragglerProcess,
                         TraceReplay, get_straggler_process)

__all__ = [
    "StragglerProcess", "IIDBernoulli", "MarkovBursty", "HeterogeneousRates",
    "TraceReplay", "get_straggler_process", "STRAGGLER_PROCESSES",
    "LinkProfile", "ComputeProfile", "StepTimer", "solve_k_budgets",
    "DEFAULT_LINK", "DEFAULT_COMPUTE",
]
