"""Span tracing: device-trace ranges + host wall-clock span timers (port of
`repro.obs.tracing`).

  * Device plane: `scope(name)` is an NVTX range (`torch.cuda.nvtx.range`,
    the card's counterpart of `jax.named_scope`): it names a phase of the
    step in a profiler's timeline and changes nothing computed.  Off a
    CUDA build it does nothing.

  * Host plane: `SpanRecorder` measures what the step's kernels cannot
    see: batch wait, prefetch queue occupancy, step dispatch, the blocking
    result fetch.  Each `span()` also enters an NVTX range and a
    `torch.profiler.record_function`, so host spans line up with the
    device trace when the profiler is on (the counterpart of
    `jax.profiler.TraceAnnotation`).  Spans render to Chrome-trace JSON
    via `trace_export.chrome_trace`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

__all__ = ["scope", "SpanRecorder"]


@contextlib.contextmanager
def scope(name: str):
    """An NVTX range around a phase (a no-op without CUDA)."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


class SpanRecorder:
    """Wall-clock host spans + counter samples for one run.

    spans:    [{"name", "tid", "t0", "t1", "args"}] seconds since `t0_s`
    counters: [{"name", "t", "value"}] point samples (queue depth etc.)
    """

    def __init__(self):
        self.t0_s = time.perf_counter()
        self.spans: List[dict] = []
        self.counters: List[dict] = []

    def now(self) -> float:
        return time.perf_counter() - self.t0_s

    @contextlib.contextmanager
    def span(self, name: str, tid: str = "host", **args):
        """Time a host-side phase; also an NVTX range and a profiler
        record_function."""
        t0 = self.now()
        with scope(name), torch.profiler.record_function(name):
            try:
                yield
            finally:
                self.spans.append({"name": name, "tid": tid, "t0": t0,
                                   "t1": self.now(),
                                   "args": {k: v for k, v in args.items()}})

    def counter(self, name: str, value: float) -> None:
        self.counters.append({"name": name, "t": self.now(),
                              "value": float(value)})

    def durations(self, name: Optional[str] = None) -> List[float]:
        """Span durations in seconds (optionally for one span name)."""
        return [s["t1"] - s["t0"] for s in self.spans
                if name is None or s["name"] == name]

    def summary_s(self) -> Dict[str, float]:
        """Total seconds per span name (the per-step host-phase budget)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s["name"]] = out.get(s["name"], 0.0) + (s["t1"] - s["t0"])
        return out
