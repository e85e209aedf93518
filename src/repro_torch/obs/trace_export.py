"""Chrome-trace / Perfetto JSON export: measured spans AND simulated steps
(the port's copy of `repro.obs.trace_export`).

Two producers, one format, so predicted and measured timelines load side
by side in chrome://tracing / ui.perfetto.dev:

  * `chrome_trace(span_events(recorder.spans))` — the measured host spans
    of a real run (`repro_torch.obs.tracing.SpanRecorder`).
  * `chrome_trace(steptimer_timeline(timer, trace))` — the simulated
    schedule of a `repro_torch.sim.cost_model.StepTimer` over a (T, N) mask
    trace: per-rank compute lanes, then the pack -> uplink -> downlink
    bucket stages laid out serially or as the 3-stage pipeline
    (`overlap=True`), mirroring `StepTimer.steps` EXACTLY — each step's
    span extent equals the closed-form step time (tested).

All event timestamps/durations are microseconds ("X" complete events, the
stable subset of the trace-event spec).  `validate_chrome_trace` is the
schema gate the tests and the CI metrics-smoke job run on every emitted
file.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["chrome_trace", "span_events", "steptimer_timeline",
           "validate_chrome_trace", "write_chrome_trace"]

TRACE_SCHEMA = "repro.obs.trace/v1"


# --------------------------------------------------------------------------
# trace-event assembly
# --------------------------------------------------------------------------

def _event(name: str, ts_s: float, dur_s: float, pid: int, tid: str,
           args: Optional[dict] = None) -> dict:
    return {"name": name, "ph": "X", "ts": ts_s * 1e6, "dur": dur_s * 1e6,
            "pid": pid, "tid": tid, "args": dict(args or {})}


def span_events(spans: Sequence[dict], pid: int = 0,
                counters: Sequence[dict] = ()) -> List[dict]:
    """`SpanRecorder.spans` (+ optional counter samples) -> trace events."""
    ev = [_event(s["name"], s["t0"], s["t1"] - s["t0"], pid,
                 s.get("tid", "host"), s.get("args")) for s in spans]
    for c in counters:
        ev.append({"name": c["name"], "ph": "C", "ts": c["t"] * 1e6,
                   "pid": pid, "args": {"value": c["value"]}})
    return ev


def chrome_trace(events: Sequence[dict],
                 metadata: Optional[dict] = None) -> dict:
    """Wrap events in the Chrome-trace JSON object form."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA, **(metadata or {})}}


def write_chrome_trace(path: str, events: Sequence[dict],
                       metadata: Optional[dict] = None) -> dict:
    obj = chrome_trace(events, metadata)
    validate_chrome_trace(obj)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def validate_chrome_trace(obj) -> None:
    """Raise ValueError unless `obj` is a loadable Chrome-trace object
    (object form, complete/counter events, finite non-negative times)."""
    if not isinstance(obj, dict):
        raise ValueError("trace must be a JSON object (object form)")
    if obj.get("otherData", {}).get("schema") != TRACE_SCHEMA:
        raise ValueError(f"trace otherData.schema != {TRACE_SCHEMA!r}")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for field in ("name", "ph", "ts", "pid"):
            if field not in e:
                raise ValueError(f"traceEvents[{i}] missing {field!r}")
        if e["ph"] not in ("X", "C", "M"):
            raise ValueError(f"traceEvents[{i}].ph {e['ph']!r} not in "
                             f"('X', 'C', 'M')")
        ts = e["ts"]
        if not (isinstance(ts, (int, float)) and math.isfinite(ts)
                and ts >= 0):
            raise ValueError(f"traceEvents[{i}].ts must be finite >= 0")
        if e["ph"] == "X":
            dur = e.get("dur")
            if not (isinstance(dur, (int, float)) and math.isfinite(dur)
                    and dur >= 0):
                raise ValueError(f"traceEvents[{i}].dur must be finite >= 0")
            if "tid" not in e:
                raise ValueError(f"traceEvents[{i}] missing tid")
    json.dumps(obj)   # everything must be JSON-serializable


# --------------------------------------------------------------------------
# simulated StepTimer schedule
# --------------------------------------------------------------------------

def steptimer_timeline(timer, trace, pid: int = 1
                       ) -> Tuple[List[dict], np.ndarray]:
    """Lay a `sim.StepTimer` schedule out as trace events.

    trace: (T, N) participation masks.  Returns (events, step_times_s);
    step_times_s[t] is the laid-out extent of step t and equals
    `timer.steps(trace)[0][t]` exactly — the timeline IS the cost model,
    just unrolled into spans (serial buckets, or the pack/uplink/downlink
    pipeline when `timer.overlap` and num_buckets > 1).
    """
    trace = np.asarray(trace, np.float64)
    if trace.ndim != 2:
        raise ValueError(f"trace must be (T, N), got shape {trace.shape}")
    T, N = trace.shape
    comp = timer.compute.rank_seconds(N)                     # (N,)
    b_up_r = timer.bytes_up_ranks(N).astype(np.float64)      # (N,)
    up_r = timer.link.up_s_ranks(b_up_r)                     # (N,)
    lat = timer.link.latency_s
    B = timer.num_buckets
    xfer_r = up_r - lat
    down_xfer = timer.link.down_s(timer.bytes_down()) - lat

    events: List[dict] = []
    step_times = np.zeros((T,), np.float64)
    cursor = 0.0
    for t in range(T):
        row = trace[t]
        participants = float(row.sum())
        has_up = participants > 0
        if has_up:
            t_comp = float(np.max(np.where(row > 0, comp, 0.0)))
            xfer_max = float(np.max(np.where(row > 0, xfer_r, 0.0)))
        else:
            t_comp = float(comp.max())     # all-straggler: timeout window
            xfer_max = 0.0
        f = timer.link.server_fanin
        waves = math.ceil(participants / f) if (f > 0 and has_up) else 1.0

        t0 = cursor
        for i in range(N):
            if row[i] > 0:
                events.append(_event("compute", t0, comp[i], pid,
                                     f"rank{i}", {"step": t}))
        if not has_up:
            events.append(_event("compute_timeout", t0, t_comp, pid,
                                 "server", {"step": t}))
        agg0 = t0 + t_comp

        if timer.overlap and B > 1:
            # 3-stage pipeline over B buckets (mirrors StepTimer's
            # pack_b + up_b + down_b + (B-1) * bottleneck closed form)
            pack_b = timer.pack_s / B
            up_b = (waves * (lat + xfer_max / B)) if has_up else 0.0
            down_b = lat + down_xfer / B
            pack_end = up_end = down_end = agg0
            for b in range(B):
                p0 = pack_end
                if pack_b > 0:
                    events.append(_event("pack", p0, pack_b, pid, "pack",
                                         {"step": t, "bucket": b}))
                pack_end = p0 + pack_b
                u0 = max(pack_end, up_end)
                if up_b > 0:
                    events.append(_event("uplink", u0, up_b, pid, "uplink",
                                         {"step": t, "bucket": b}))
                up_end = u0 + up_b
                d0 = max(up_end, down_end)
                events.append(_event("downlink", d0, down_b, pid,
                                     "downlink", {"step": t, "bucket": b}))
                down_end = d0 + down_b
            t_end = down_end
        else:
            cur = agg0
            if timer.pack_s > 0:
                events.append(_event("pack", cur, timer.pack_s, pid, "pack",
                                     {"step": t}))
                cur += timer.pack_s
            if has_up:
                up_b = waves * (lat + xfer_max / B)
                for b in range(B):
                    events.append(_event("uplink", cur, up_b, pid, "uplink",
                                         {"step": t, "bucket": b}))
                    cur += up_b
            down_b = lat + down_xfer / B
            for b in range(B):
                events.append(_event("downlink", cur, down_b, pid,
                                     "downlink", {"step": t, "bucket": b}))
                cur += down_b
            t_end = cur

        events.append(_event("step", t0, t_end - t0, pid, "step",
                             {"step": t, "participants": participants}))
        step_times[t] = t_end - t0
        cursor = t_end
    return events, step_times
