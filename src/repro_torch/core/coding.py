"""Stochastic gradient coding: data allocation, encode weights and the
straggler masks (port of `repro.core.coding`).

Host-side numpy in float64, cast to f32 at the end: the same arithmetic as
the JAX package, so W is bit-identical.  `random_allocation` draws from
the same `np.random.default_rng` stream as JAX's, and `straggler_mask`
from `core/prng.py`'s copy of `jax.random`.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng

__all__ = ["Allocation", "cyclic_allocation", "random_allocation",
           "rate_aware_allocation", "expected_coverage", "encode_weights",
           "straggler_mask", "redundancy_theta"]


@dataclasses.dataclass(frozen=True)
class Allocation:
    """S: (N, M) 0/1 matrix, S[i, k] = 1 iff subset k lives on rank i."""

    S: np.ndarray  # (N, M) int8

    @property
    def num_devices(self) -> int:
        return self.S.shape[0]

    @property
    def num_subsets(self) -> int:
        return self.S.shape[1]

    @property
    def d(self) -> np.ndarray:
        """d_k = number of ranks holding subset k, shape (M,)."""
        return self.S.sum(axis=0)

    def subsets_of(self, device: int) -> np.ndarray:
        return np.nonzero(self.S[device])[0]

    def validate(self) -> None:
        if (self.d == 0).any():
            raise ValueError("every subset must be allocated to >=1 device")


def random_allocation(seed: int, num_devices: int, num_subsets: int,
                      d: int) -> Allocation:
    """Subset k on d distinct ranks drawn uniformly (the paper's
    approximation of the pairwise-balanced scheme, Sec. V.A)."""
    rng = np.random.default_rng(seed)
    S = np.zeros((num_devices, num_subsets), dtype=np.int8)
    for k in range(num_subsets):
        devs = rng.choice(num_devices, size=min(d, num_devices),
                          replace=False)
        S[devs, k] = 1
    alloc = Allocation(S=S)
    alloc.validate()
    return alloc


def cyclic_allocation(num_devices: int, num_subsets: int, d: int
                      ) -> Allocation:
    """Subset k on ranks k, k+1, ..., k+d-1 (mod N)."""
    S = np.zeros((num_devices, num_subsets), dtype=np.int8)
    for k in range(num_subsets):
        for j in range(min(d, num_devices)):
            S[(k + j) % num_devices, k] = 1
    alloc = Allocation(S=S)
    alloc.validate()
    return alloc


def expected_coverage(alloc: Allocation,
                      rates: Sequence[float]) -> np.ndarray:
    """Per-subset P(at least one holder participates) under per-rank
    participation rates q_i, shape (M,):  1 - prod_{i in S_k} (1 - q_i)."""
    q = np.asarray(rates, np.float64)
    if q.shape != (alloc.num_devices,):
        raise ValueError(f"need {alloc.num_devices} per-rank rates, got "
                         f"shape {q.shape}")
    miss = np.prod(np.where(alloc.S > 0, (1.0 - q)[:, None], 1.0), axis=0)
    return 1.0 - miss


def rate_aware_allocation(rates: Sequence[float], num_subsets: int, d: int,
                          *, load_slack: float = 1.25,
                          exact_load: bool = False) -> Allocation:
    """Heterogeneity-aware allocation: greedy expected-coverage maximization
    under per-rank participation rates q_i.

    Spends the same total replica budget as a uniform-d allocation (d * M
    replicas) but lets d_k vary: every subset starts on its cyclic home rank
    (data locality), then each remaining replica goes to the (subset, rank)
    pair with the largest marginal gain in expected coverage

        gain(k, i) = P(no current holder of k participates) * q_i ,

    subject to the balanced per-rank load cap ceil(load_slack * d * M / N).
    Subsets homed on unreliable ranks have the largest miss probability, so
    the extra redundancy concentrates exactly where the fleet is weak (the
    heterogeneous-system placement of Song & Choi).  Deterministic.

    The greedy maximum is tracked with a lazy max-heap keyed on the
    factored gain miss_k * q_best(k): a placement only ever *lowers* gains
    (miss_k shrinks, ranks fill up), so a popped entry whose miss/holder
    snapshot is stale can be recomputed and re-pushed without losing the
    true maximum.  O(budget * (log M + N)) instead of the dense
    O(budget * N * M) argmax scan — 1024 ranks allocate in milliseconds.

    exact_load=True replaces the slack cap with the exact per-rank load
    d * M / N (N must divide the budget) and spends any greedy remainder
    in a repair pass, so every rank holds exactly d * M / N subsets.  The
    mesh train path needs this: a uniform per-rank subset count keeps the
    stacked batch shape (and therefore the compiled step) stable across
    re-allocations.
    """
    q = np.asarray(rates, np.float64)
    N, M = q.shape[0], num_subsets
    if N < 1 or M < 1:
        raise ValueError("need at least one device and one subset")
    if np.any(q < 0.0) or np.any(q > 1.0):
        raise ValueError("every participation rate must be in [0, 1]")
    d_eff = min(max(int(d), 1), N)
    S = np.zeros((N, M), dtype=np.int8)
    homes = np.arange(M) % N
    S[homes, np.arange(M)] = 1
    load = np.bincount(homes, minlength=N).astype(np.int64)
    miss = 1.0 - q[homes]                            # per-subset miss prob
    if exact_load:
        if (d_eff * M) % N:
            raise ValueError(
                f"exact_load needs N={N} to divide the replica budget "
                f"d*M={d_eff * M}")
        cap = d_eff * M // N
    else:
        cap = int(np.ceil(load_slack * d_eff * M / N))

    def _best(k: int) -> int:
        """Most reliable rank that can still take subset k (tie: lowest
        rank index, matching the old dense-argmax order), or -1."""
        avail = (S[:, k] == 0) & (load < cap)
        if not avail.any():
            return -1
        return int(np.argmax(np.where(avail, q, -1.0)))

    heap: list = []
    for k in range(M):
        i = _best(k)
        if i >= 0:
            heapq.heappush(heap, (-(miss[k] * q[i]), i, k, miss[k]))
    budget = d_eff * M - M
    placed = 0
    while placed < budget and heap:
        _, i, k, m_snap = heapq.heappop(heap)
        if m_snap != miss[k] or S[i, k] or load[i] >= cap:
            i = _best(k)                             # stale -> recompute
            if i >= 0:
                heapq.heappush(heap, (-(miss[k] * q[i]), i, k, miss[k]))
            continue
        S[i, k] = 1
        load[i] += 1
        miss[k] *= 1.0 - q[i]
        placed += 1
        j = _best(k)
        if j >= 0:
            heapq.heappush(heap, (-(miss[k] * q[j]), j, k, miss[k]))
    if exact_load and placed < budget:
        # Greedy can strand budget (a subset already on every non-full
        # rank).  Spend the remainder on the emptiest rank x its
        # highest-miss unheld subset: always feasible, since load < cap
        # <= M implies an unheld subset exists, and the counting argument
        # (total = cap * N, each load <= cap) then forces load == cap
        # everywhere once the budget is gone.
        while placed < budget:
            open_load = np.where(load < cap, load, np.iinfo(np.int64).max)
            i = int(np.argmin(open_load))
            ks = np.nonzero(S[i] == 0)[0]
            k = int(ks[np.argmax(miss[ks])])
            S[i, k] = 1
            load[i] += 1
            miss[k] *= 1.0 - q[i]
            placed += 1
    alloc = Allocation(S=S)
    alloc.validate()
    return alloc


def encode_weights(alloc: Allocation, p: Optional[float] = None,
                   rates: Optional[Sequence[float]] = None) -> np.ndarray:
    """Encode weights making the masked aggregate unbiased, (N, M) f32.

      p      W[i, k] = S[i, k] / (d_k * (1 - p))        (eq. 3)
      rates  W[i, k] = S[i, k] / sum_j S[j, k] * q_j    (rate-aware;
             uniform rates reduce to the eq.-3 product bit for bit)
    """
    if (p is None) == (rates is None):
        raise ValueError("give exactly one of p (eq. 3) or rates (per-rank)")
    if p is not None:
        if not 0.0 <= p < 1.0:
            raise ValueError(f"straggler probability p={p} must be in [0, 1)")
        denom = alloc.d.astype(np.float64) * (1.0 - p)
    else:
        q = np.asarray(rates, np.float64)
        if q.shape != (alloc.num_devices,):
            raise ValueError(f"need {alloc.num_devices} per-rank rates, got "
                             f"shape {q.shape}")
        if np.any(q < 0.0) or np.any(q > 1.0):
            raise ValueError("every participation rate must be in [0, 1]")
        if np.all(q == q[0]):
            denom = alloc.d.astype(np.float64) * q[0]
        else:
            denom = alloc.S.astype(np.float64).T @ q
        if np.any(denom <= 0.0):
            bad = np.nonzero(denom <= 0.0)[0].tolist()
            raise ValueError(
                f"subsets {bad} have zero expected coverage (every holder "
                f"has participation rate 0) — add redundancy on live ranks")
    W = alloc.S.astype(np.float64) / denom[None, :]
    return W.astype(np.float32)


def straggler_mask(key: np.ndarray, step: int, num_devices: int,
                   p: float) -> torch.Tensor:
    """I^t in {0, 1}^N (eq. 8) as (N,) f32 on the CPU: rank i participates
    iff uniform(fold_in(key, step), (N,))[i] >= p; pure in (key, step), so
    every rank derives the same mask without communication."""
    u = prng.uniform(prng.fold_in(key, step), (num_devices,))
    return torch.from_numpy((u >= np.float32(p)).astype(np.float32))


def redundancy_theta(alloc: Allocation) -> float:
    """theta = sum_k (1/d_k - 1/N) (eq. 18); 0 under full replication."""
    d = alloc.d.astype(np.float64)
    return float(np.sum(1.0 / d - 1.0 / alloc.num_devices))
