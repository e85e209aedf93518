"""Straggler processes: per-step participation masks I^t (port of
`repro.sim.stragglers`).

Every process answers `mask(seed, step)` -> (N,) f32 in {0, 1} on the CPU,
1 = the rank participates, pure in (seed, step), where the seed is JAX's
`PRNGKey(seed)`: every mask equals JAX's `process.mask(PRNGKey(seed),
step)` bit for bit, since the uniforms come from `core/prng.py`'s copy of
`jax.random` and each threshold is compared in f32 as JAX compares it.

  IIDBernoulli        eq. (8): each rank straggles with probability p.
  MarkovBursty        per-rank two-state (fast/slow) Markov chain: slow
                      bursts of geometric length (mean `mean_burst`),
                      stationary straggle probability p.
  HeterogeneousRates  independent Bernoulli with per-rank p_i (linear or
                      two-class profiles, or explicit rates).
  TraceReplay         masks replayed from a recorded trace (mask JSON or a
                      per-rank availability CSV), cyclic past its end.

`sample_trace(seed, T)` is the (T, N) mask matrix of steps 0..T-1, by
definition `[mask(seed, t) for t in range(T)]`: both run `_masks` over a
vector of steps, so the cost model and the training dynamics see the same
masks.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import prng

__all__ = ["StragglerProcess", "IIDBernoulli", "MarkovBursty",
           "HeterogeneousRates", "TraceReplay", "get_straggler_process",
           "STRAGGLER_PROCESSES"]


@dataclasses.dataclass(frozen=True)
class StragglerProcess:
    """Base class: `_masks(key, steps)` gives the (S, N) f32 masks of a
    vector of steps; `rates()` the marginal participation per rank."""

    num_devices: int

    def _masks(self, key: np.ndarray, steps: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def mask(self, seed: int, step: int) -> torch.Tensor:
        """(N,) f32 participation indicators on the CPU; pure in (seed,
        step)."""
        m = self._masks(prng.PRNGKey(seed), np.asarray([step], np.int64))
        return torch.from_numpy(m[0])

    def rates(self) -> np.ndarray:
        """(N,) marginal participation probability per rank (1 - p_i)."""
        raise NotImplementedError

    def sample_trace(self, seed: int, T: int) -> np.ndarray:
        """(T, N) f32 0/1 masks of steps 0..T-1: the sequence training
        sees."""
        return self._masks(prng.PRNGKey(seed), np.arange(T, dtype=np.int64))


def _bernoulli(key: np.ndarray, steps: np.ndarray, n: int,
               p_f32: np.ndarray) -> np.ndarray:
    """uniform(fold_in(key, step), (n,)) >= p per step, compared in f32."""
    u = prng.uniform_rows(prng.fold_in_many(key, steps), n)
    return (u >= p_f32).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class IIDBernoulli(StragglerProcess):
    """The paper's eq.-(8) model: each rank independently straggles with
    probability p each step (JAX's `coding.straggler_mask`)."""

    p: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"straggle probability p={self.p} not in [0, 1)")

    def _masks(self, key, steps):
        return _bernoulli(key, steps, self.num_devices, np.float32(self.p))

    def rates(self):
        return np.full((self.num_devices,), 1.0 - self.p)


@dataclasses.dataclass(frozen=True)
class MarkovBursty(StragglerProcess):
    """Per-rank two-state Markov chain: exit q = 1/mean_burst (slow ->
    fast), entry r = p*q/(1-p) (fast -> slow), so P(slow) = p and slow
    runs are Geometric(q).

    Pure in (seed, step) through the monotone-coupling collapse of JAX's
    version: the shared per-step uniforms u_s = U(fold_in(key, s)) of the
    `window` steps up to `step` (negative steps wrap through uint32, a
    consistent virtual past) drive the chain from a stationary draw at the
    window's far edge, U(fold_in(fold_in(key, s_0), 0x5EED)) < p; each
    step the rank is slow iff u_s < (1 - q if slow else r), thresholds in
    f32."""

    p: float = 0.1
    mean_burst: float = 8.0
    window: int = 64

    def __post_init__(self):
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"stationary straggle p={self.p} not in [0, 1)")
        if self.mean_burst < 1.0:
            raise ValueError("mean_burst must be >= 1 step")
        q, r = self._qr()
        if r > 1.0 - q:
            raise ValueError(
                f"entry rate r={r:.3f} > 1-q={1-q:.3f}: burst too short for "
                f"this straggle probability (raise mean_burst or lower p)")

    def _qr(self) -> Tuple[float, float]:
        q = 1.0 / self.mean_burst
        r = self.p * q / (1.0 - self.p) if self.p > 0 else 0.0
        return q, r

    def _masks(self, key, steps):
        n, w = self.num_devices, self.window
        q, r = self._qr()
        # steps of each window, as JAX's int32 arithmetic (then wrapped)
        win = (steps.astype(np.int32)[:, None] - np.int32(w - 1)
               + np.arange(w, dtype=np.int32))                 # (S, w)
        uniq, inv = np.unique(win, return_inverse=True)
        u = prng.uniform_rows(prng.fold_in_many(key, uniq), n)[
            inv.reshape(win.shape)]                             # (S, w, n)
        seed_keys = prng.fold_in_many(prng.fold_in_many(key, win[:, 0]),
                                      np.full(len(steps), 0x5EED))
        slow = prng.uniform_rows(seed_keys, n) < np.float32(self.p)
        slow_thr, fast_thr = np.float32(1.0 - q), np.float32(r)
        for j in range(w):
            slow = u[:, j] < np.where(slow, slow_thr, fast_thr)
        return (~slow).astype(np.float32)

    def rates(self):
        return np.full((self.num_devices,), 1.0 - self.p)


def _linear_rates(num_devices: int, p: float, spread: float
                  ) -> Tuple[float, ...]:
    """Per-rank straggle probabilities p_i = p * (1 +/- spread), linearly
    spaced from rank 0 (fastest) to rank N-1 (slowest); raises unless
    every p_i lands in [0, 1)."""
    if spread < 0.0:
        raise ValueError(f"straggler spread={spread} must be >= 0")
    lo, hi = p * (1.0 - spread), p * (1.0 + spread)
    if lo < 0.0 or hi >= 1.0:
        raise ValueError(
            f"spread={spread} puts per-rank straggle probabilities in "
            f"[{lo:.3f}, {hi:.3f}], outside [0, 1) — lower p or spread")
    ps = np.linspace(lo, hi, max(num_devices, 1))
    return tuple(float(x) for x in ps)


@dataclasses.dataclass(frozen=True)
class HeterogeneousRates(StragglerProcess):
    """Independent Bernoulli stragglers with per-rank probability p_i
    (persistent speed heterogeneity, Song & Choi 2021); p_i compared in
    f32."""

    p_ranks: Tuple[float, ...] = ()

    def __post_init__(self):
        if len(self.p_ranks) != self.num_devices:
            raise ValueError(f"need {self.num_devices} per-rank rates, got "
                             f"{len(self.p_ranks)}")
        ps = np.asarray(self.p_ranks, np.float64)
        if ps.size and (np.any(ps < 0.0) or np.any(ps >= 1.0)):
            raise ValueError("every p_i must be in [0, 1)")

    @classmethod
    def linear(cls, num_devices: int, p: float,
               spread: float = 0.5) -> "HeterogeneousRates":
        """Linear speed profile around mean straggle probability p."""
        return cls(num_devices=num_devices,
                   p_ranks=_linear_rates(num_devices, p, spread))

    @classmethod
    def two_class(cls, num_devices: int, p_slow: float, p_fast: float = 0.0,
                  slow_fraction: float = 0.25) -> "HeterogeneousRates":
        """A slow minority (first ceil(f*N) ranks) in a fast fleet."""
        n_slow = int(np.ceil(slow_fraction * num_devices))
        ps = (p_slow,) * n_slow + (p_fast,) * (num_devices - n_slow)
        return cls(num_devices=num_devices, p_ranks=ps)

    def _masks(self, key, steps):
        return _bernoulli(key, steps, self.num_devices,
                          np.asarray(self.p_ranks, np.float32))

    def rates(self):
        return 1.0 - np.asarray(self.p_ranks, np.float64)


@dataclasses.dataclass(frozen=True)
class TraceReplay(StragglerProcess):
    """Replay of a recorded mask trace; the seed is ignored, and steps past
    the trace's length wrap around."""

    masks: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        if not self.masks:
            raise ValueError("empty trace")
        if any(len(row) != self.num_devices for row in self.masks):
            raise ValueError("every trace row must have num_devices entries")
        if not np.isin(np.asarray(self.masks), (0, 1)).all():
            raise ValueError("trace entries must be 0/1")

    @property
    def length(self) -> int:
        return len(self.masks)

    def _masks(self, key, steps):
        arr = np.asarray(self.masks, np.float32)
        return arr[steps.astype(np.int32) % self.length]

    def rates(self):
        return np.asarray(self.masks, np.float64).mean(axis=0)

    @classmethod
    def from_array(cls, masks) -> "TraceReplay":
        arr = np.asarray(masks)
        return cls(num_devices=arr.shape[1],
                   masks=tuple(map(tuple,
                                   np.rint(arr).astype(np.int64).tolist())))

    @classmethod
    def from_json(cls, path: Union[str, Path]) -> "TraceReplay":
        obj = json.loads(Path(path).read_text())
        return cls.from_array(obj["masks"])

    @classmethod
    def from_csv(cls, path: Union[str, Path]) -> "TraceReplay":
        """Per-rank availability CSV: one row per step, one column per rank
        (1 = participated, 0 = straggled).  A leading non-numeric header
        row is skipped; fractional availabilities round to the nearest of
        {0, 1} (>= 0.5 counts as available)."""
        path = Path(path)
        rows = []
        with open(path) as f:
            for ln, line in enumerate(f):
                cells = [c.strip() for c in line.strip().split(",")]
                if not any(cells):
                    continue                       # blank line
                try:
                    vals = [float(c) for c in cells]
                except ValueError:
                    if ln == 0 and not rows:
                        continue                   # header row
                    raise ValueError(
                        f"{path}: non-numeric entry on line {ln + 1} "
                        f"(only line 1 may be a header)")
                if rows and len(vals) != len(rows[0]):
                    raise ValueError(
                        f"{path}: line {ln + 1} has {len(vals)} columns, "
                        f"expected {len(rows[0])} (one per rank)")
                rows.append(vals)
        if not rows:
            raise ValueError(f"{path}: empty availability CSV")
        return cls.from_array(np.asarray(rows, np.float64))

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "TraceReplay":
        """`*.csv` through `from_csv`, anything else through `from_json`
        (the format `to_json` writes)."""
        path = Path(path)
        if path.suffix.lower() == ".csv":
            return cls.from_csv(path)
        return cls.from_json(path)

    def to_json(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {"num_devices": self.num_devices,
             "masks": [list(row) for row in self.masks]}))
        return path


STRAGGLER_PROCESSES = ("iid", "markov", "hetero", "trace")


def get_straggler_process(name: str, num_devices: int, p: float = 0.0, *,
                          mean_burst: float = 8.0, spread: float = 0.5,
                          trace: Optional[Union[str, Path]] = None,
                          ) -> StragglerProcess:
    """The `--straggler` registry, with JAX's validation:

    iid     IIDBernoulli(p)
    markov  MarkovBursty(p, mean_burst)
    hetero  HeterogeneousRates.linear(p, spread)
    trace   TraceReplay.from_file(trace) (mask JSON or availability CSV)
    """
    if name != "trace" and not 0.0 <= p < 1.0:
        raise ValueError(f"straggle probability p={p} must be in [0, 1)")
    if name == "iid":
        return IIDBernoulli(num_devices=num_devices, p=p)
    if name == "markov":
        return MarkovBursty(num_devices=num_devices, p=p,
                            mean_burst=mean_burst)
    if name == "hetero":
        return HeterogeneousRates.linear(num_devices, p, spread)
    if name == "trace":
        if trace is None:
            raise ValueError("straggler='trace' needs a trace path "
                             "(recorded-mask JSON or availability CSV)")
        proc = TraceReplay.from_file(trace)
        if proc.num_devices != num_devices:
            raise ValueError(f"trace has {proc.num_devices} devices, the run "
                             f"has {num_devices}")
        return proc
    raise KeyError(f"unknown straggler process {name!r}; "
                   f"have {STRAGGLER_PROCESSES}")
