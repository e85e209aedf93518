"""simulate_run: turn a trial into (time, loss) curves (port of
`repro.sim.simulate`).

A `StragglerProcess` and a `StepTimer` yield the simulated wall-clock of
every step and the bytes each step put on the wire; `simulate_run` replays
the mask trace of the trial's seed through the cost model and returns the
cumulative time and bytes, which `attach_times` aligns to any recorded
step axis.  Plain numpy, as JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .cost_model import StepTimer
from .stragglers import StragglerProcess

__all__ = ["SimRun", "simulate_run", "attach_times", "time_to_target"]


@dataclasses.dataclass(frozen=True)
class SimRun:
    """Per-step simulated timeline of one run (arrays of length T)."""

    step_time_s: np.ndarray
    cum_time_s: np.ndarray
    bytes_up: np.ndarray
    bytes_down: np.ndarray
    participants: np.ndarray

    @property
    def total_time_s(self) -> float:
        return float(self.cum_time_s[-1])

    @property
    def total_bytes_on_wire(self) -> int:
        return int(self.bytes_up.sum() + self.bytes_down.sum())

    def at_steps(self, steps: Sequence[int]) -> Dict[str, List[float]]:
        """Cumulative time/bytes AFTER each recorded step index."""
        idx = np.asarray(steps, np.int64)
        return {
            "time_s": self.cum_time_s[idx].tolist(),
            "bytes_up_cum": np.cumsum(self.bytes_up)[idx].tolist(),
            "bytes_down_cum": np.cumsum(self.bytes_down)[idx].tolist(),
        }


def simulate_run(process: StragglerProcess, timer: StepTimer, T: int,
                 seed: int) -> SimRun:
    """Simulate T steps over `process.sample_trace(seed, T)` (seed as
    JAX's `PRNGKey(seed)`): pass the trial's mask seed so timing and
    dynamics share one trace."""
    trace = process.sample_trace(seed, T)
    times, b_up, b_down = timer.steps(trace)
    return SimRun(step_time_s=times, cum_time_s=np.cumsum(times),
                  bytes_up=b_up, bytes_down=b_down,
                  participants=trace.sum(axis=1))


def attach_times(hist: Dict[str, list], sim: SimRun) -> Dict[str, list]:
    """Join a recorded trial history {step, loss, ...} with the simulated
    timeline: adds time_s / bytes_*_cum columns aligned to hist['step']."""
    out = dict(hist)
    out.update(sim.at_steps(hist["step"]))
    return out


def time_to_target(times: Sequence[float], losses: Sequence[float],
                   target: float) -> Optional[float]:
    """First time the loss curve reaches `target` (linear interpolation
    between recorded points); None if it never does."""
    t = np.asarray(times, np.float64)
    l = np.asarray(losses, np.float64)
    below = np.nonzero(l <= target)[0]
    if below.size == 0:
        return None
    j = int(below[0])
    if j == 0:
        return float(t[0])
    l0, l1, t0, t1 = l[j - 1], l[j], t[j - 1], t[j]
    if l0 == l1:
        return float(t1)
    frac = (l0 - target) / (l0 - l1)
    return float(t0 + frac * (t1 - t0))
