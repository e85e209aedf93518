"""Straggler processes (port of `repro.sim.stragglers`: the iid Bernoulli
process of eq. 8 only).

`mask(seed, step)` is pure in (seed, step): it draws from a generator
seeded with both, so every caller derives the same mask.  The bits differ
from `jax.random`'s; tests that compare with JAX pass JAX's masks in.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.pipeline import generator_for

__all__ = ["IIDBernoulli"]


@dataclasses.dataclass(frozen=True)
class IIDBernoulli:
    """Each of `num_devices` ranks straggles with probability p per step."""

    num_devices: int
    p: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"straggle probability p={self.p} not in [0, 1)")

    def mask(self, seed: int, step: int) -> torch.Tensor:
        """(N,) f32 in {0, 1} on the CPU; 1 = the rank participates."""
        u = torch.rand(self.num_devices,
                       generator=generator_for(seed, 0x5A5A, step))
        return (u >= self.p).to(torch.float32)

    def rates(self) -> np.ndarray:
        """(N,) participation probability per rank (1 - p)."""
        return np.full((self.num_devices,), 1.0 - self.p)
