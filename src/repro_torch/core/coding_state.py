"""The live coding plane: online rate estimates -> encode weights ->
allocation (port of `repro.core.coding_state`).

  `RateEstimator`  bias-corrected per-rank EWMA of the observed masks.
  `CodingState`    (rates_estimate, W, epoch), which the elastic train step
                   takes each step; W stays on the host (numpy f32), which
                   folds it into the batch weights.
  `CodingPlan`     the host-side controller: `maybe_replan(rates)` refits
                   the encode weights on every call and re-runs
                   `rate_aware_allocation` only when an estimate drifts
                   past `drift_threshold` (epoch bump: the batch maker
                   takes the new subset ids; error feedback is untouched).

With the estimate pinned to the oracle rates, `CodingPlan` gives the static
`encode_weights(alloc, rates=...)` bit for bit, so the elastic path equals
the static path exactly.  All of it is float64 numpy, JAX's expressions in
JAX's order, so it equals JAX's plane bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import coding

__all__ = ["CodingState", "RateEstimator", "CodingPlan", "maybe_replan"]


class CodingState(NamedTuple):
    """rates_estimate (N,) f32, W (N, M) f32 and the allocation epoch."""

    rates_estimate: np.ndarray
    W: np.ndarray
    epoch: int

    @classmethod
    def create(cls, rates: Sequence[float], W: np.ndarray,
               epoch: int = 0) -> "CodingState":
        return cls(rates_estimate=np.asarray(rates, np.float32),
                   W=np.asarray(W, np.float32), epoch=int(epoch))


class RateEstimator:
    """Bias-corrected online EWMA of participation masks: accumulates from
    zero and divides by 1 - (1-alpha)^t, so the step-t estimate is an exact
    weighted average of the masks seen (at t = 1, the first mask).
    Per-rank step counts make it elastic: `resize` keeps the survivors'
    statistics and starts joiners from the prior."""

    def __init__(self, num_ranks: int, *, alpha: float = 0.1,
                 prior: float = 1.0):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha={alpha} must be in (0, 1]")
        if not (0.0 <= prior <= 1.0):
            raise ValueError(f"prior={prior} must be in [0, 1]")
        self.alpha = float(alpha)
        self.prior = float(prior)
        self._s = np.zeros(num_ranks, np.float64)
        self._t = np.zeros(num_ranks, np.int64)

    @property
    def num_ranks(self) -> int:
        return self._s.shape[0]

    @property
    def steps_seen(self) -> np.ndarray:
        return self._t.copy()

    def update(self, mask: Sequence[float]) -> np.ndarray:
        """Fold one observed participation mask in; returns `rates`."""
        m = np.asarray(mask, np.float64)
        if m.shape != self._s.shape:
            raise ValueError(f"mask shape {m.shape} != ({self.num_ranks},)")
        a = self.alpha
        self._s = (1.0 - a) * self._s + a * m
        self._t += 1
        return self.rates

    @property
    def rates(self) -> np.ndarray:
        """(N,) bias-corrected estimate; ranks with no observations yet
        report the prior."""
        # a float64 exponent (libm pow): numpy's integer-exponent power
        # differs in the last ulp
        corr = 1.0 - (1.0 - self.alpha) ** self._t.astype(np.float64)
        return np.where(self._t > 0, self._s / np.where(corr > 0, corr, 1.0),
                        self.prior)

    def resize(self, num_new: int,
               survivors: Optional[Sequence[int]] = None) -> None:
        """Membership change: keep the survivors' statistics (default: the
        first min(N_old, N_new) ranks, the `elastic_rescale_ef`
        convention); joiners report the prior until their first mask."""
        if survivors is None:
            survivors = range(min(self.num_ranks, num_new))
        idx = np.asarray(list(survivors), np.int64)
        if idx.size > num_new or (idx.size and
                                  (idx.min() < 0 or
                                   idx.max() >= self.num_ranks)):
            raise ValueError(f"bad survivor indices {idx} for "
                             f"{self.num_ranks} -> {num_new} ranks")
        s = np.zeros(num_new, np.float64)
        t = np.zeros(num_new, np.int64)
        s[:idx.size] = self._s[idx]
        t[:idx.size] = self._t[idx]
        self._s, self._t = s, t


@dataclasses.dataclass
class CodingPlan:
    """Host-side replan controller over (allocation, encode weights).

    Every `maybe_replan(rates)` refits W to the clipped estimates against
    the current allocation; the allocation is recomputed (epoch bump) only
    when some estimate has drifted more than `drift_threshold` from the
    rates it was planned for.  `min_rate` floors the estimates before the
    fit, so a rank not yet seen participating cannot get an infinite
    weight.  `replan_hook` (e.g. `sim.planner.elastic_replan_hook`) is
    called with the clipped estimates on every drift-triggered
    re-allocation, and what it returns lands in info["plan_ranking"]; it
    advises and must not mutate the plan.
    """

    allocation: coding.Allocation
    rates_planned: np.ndarray            # (N,) f64 rates the allocation saw
    d: int
    epoch: int = 0
    drift_threshold: float = 0.1
    min_rate: float = 0.05
    load_slack: float = 1.25
    exact_load: bool = False
    replan_hook: Optional[Callable[[np.ndarray], object]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def create(cls, rates: Sequence[float], num_subsets: int, d: int, *,
               drift_threshold: float = 0.1, min_rate: float = 0.05,
               load_slack: float = 1.25, exact_load: bool = False,
               allocation: Optional[coding.Allocation] = None,
               replan_hook: Optional[Callable[[np.ndarray], object]] = None,
               ) -> "CodingPlan":
        """Plan from initial rates.  Pass `allocation` to keep an existing
        placement (the static setup's), so epoch 0 of the elastic path is
        the static path bit for bit."""
        q = np.asarray(rates, np.float64)
        if allocation is None:
            allocation = coding.rate_aware_allocation(
                q, num_subsets, d, load_slack=load_slack,
                exact_load=exact_load)
        return cls(allocation=allocation, rates_planned=q.copy(), d=int(d),
                   drift_threshold=drift_threshold, min_rate=min_rate,
                   load_slack=load_slack, exact_load=exact_load,
                   replan_hook=replan_hook)

    def clip(self, rates: Sequence[float]) -> np.ndarray:
        return np.clip(np.asarray(rates, np.float64), self.min_rate, 1.0)

    def state(self, rates: Optional[Sequence[float]] = None,
              *, clip: bool = True) -> CodingState:
        """CodingState of the current allocation at the given (default:
        planned) rates.  clip=False gives the static path's W bit for bit
        (the static path never clips its oracle rates)."""
        q = np.asarray(self.rates_planned if rates is None else rates,
                       np.float64)
        if clip:
            q = self.clip(q)
        W = coding.encode_weights(self.allocation, rates=q)
        return CodingState.create(q, W, self.epoch)

    def maybe_replan(self, rates: Sequence[float],
                     *, clip: bool = True) -> Tuple[CodingState, dict]:
        """One control tick: always refit W; re-allocate on drift.
        Returns (state, info) with info {"epoch", "drift", "reallocated",
        "rates_estimate"}."""
        q = np.asarray(rates, np.float64)
        if clip:
            q = self.clip(q)
        drift = float(np.max(np.abs(q - self.rates_planned))) \
            if q.shape == self.rates_planned.shape else float("inf")
        reallocated = drift > self.drift_threshold
        if reallocated:
            self.allocation = coding.rate_aware_allocation(
                q, self.allocation.num_subsets, self.d,
                load_slack=self.load_slack, exact_load=self.exact_load)
            self.rates_planned = q.copy()
            self.epoch += 1
        st = CodingState.create(
            q, coding.encode_weights(self.allocation, rates=q), self.epoch)
        info = {"epoch": self.epoch, "drift": drift,
                "reallocated": bool(reallocated),
                "rates_estimate": q.tolist()}
        if reallocated and self.replan_hook is not None:
            info["plan_ranking"] = self.replan_hook(q)
        return st, info

    def resize(self, rates: Sequence[float], num_subsets: int) -> None:
        """Membership change: re-plan the placement for the new fleet size
        (always an epoch bump: the old S has the wrong shape)."""
        q = self.clip(rates)
        self.allocation = coding.rate_aware_allocation(
            q, num_subsets, self.d, load_slack=self.load_slack,
            exact_load=self.exact_load)
        self.rates_planned = np.asarray(q, np.float64).copy()
        self.epoch += 1


def maybe_replan(plan: CodingPlan,
                 rates: Optional[Sequence[float]]) -> Tuple[CodingState, dict]:
    """One tick; `rates=None` (the estimator has seen nothing) keeps the
    planned rates."""
    if rates is None:
        return plan.state(), {"epoch": plan.epoch, "drift": 0.0,
                              "reallocated": False,
                              "rates_estimate":
                                  plan.rates_planned.tolist()}
    return plan.maybe_replan(rates)
