"""Stochastic gradient coding: data allocation, encode weights and the
straggler masks (port of `repro.core.coding`).

Host-side numpy in float64, cast to f32 at the end: the same arithmetic as
the JAX package, so W is bit-identical.  `random_allocation` draws from
the same `np.random.default_rng` stream as JAX's, and `straggler_mask`
from `core/prng.py`'s copy of `jax.random`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng

__all__ = ["Allocation", "cyclic_allocation", "random_allocation",
           "encode_weights", "straggler_mask", "redundancy_theta"]


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
