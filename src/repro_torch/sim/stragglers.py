"""Straggler processes (port of `repro.sim.stragglers`: the iid Bernoulli
process of eq. 8 only).

`mask(seed, step)` is pure in (seed, step) and equals JAX's
`coding.straggler_mask(PRNGKey(seed), step, N, p)` bit for bit: the
uniforms come from `core/prng.py`'s copy of `jax.random`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import coding, prng

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
        """(N,) f32 in {0, 1} on the CPU; 1 = the rank participates:
        uniform(fold_in(PRNGKey(seed), step), (N,)) >= p."""
        return coding.straggler_mask(prng.PRNGKey(seed), step,
                                     self.num_devices, self.p)

    def rates(self) -> np.ndarray:
        """(N,) participation probability per rank (1 - p)."""
        return np.full((self.num_devices,), 1.0 - self.p)
