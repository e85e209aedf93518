"""Serve-plane telemetry: per-request queue wait + latency histograms (the
port's copy of `repro.obs.serving`).

`ServeTelemetry` is the host-side sink for the serving path
(`repro_torch.launch.serve.instrument_steps` feeds it): per-call prefill
and per-token decode latencies (measured around the step, synchronised
with the card), plus per-request queue wait recorded by the request loop.
Summaries are p50/p99/mean histograms (`logger.percentiles_ms`), emitted
as schema-validated `serve_summary` / `serve_request` JSONL records, and
the underlying spans render to the same Chrome-trace JSON as the train
plane (`trace_export`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .logger import percentiles_ms
from .tracing import SpanRecorder

__all__ = ["ServeTelemetry", "RequestRecord"]


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    request_id: int
    queue_wait_s: float
    prefill_s: float
    decode_s: float
    tokens: int

    def to_record(self) -> dict:
        return {"kind": "serve_request", "request_id": int(self.request_id),
                "queue_wait_s": float(self.queue_wait_s),
                "prefill_s": float(self.prefill_s),
                "decode_s": float(self.decode_s),
                "tokens": int(self.tokens)}


class ServeTelemetry:
    """Latency samples + spans for one serving session.

    prefill_s:      one sample per prefill call (blocking wall clock)
    decode_token_s: one sample per decode step (one generated token)
    queue_wait_s:   one sample per request (arrival -> service start)
    """

    def __init__(self, recorder: Optional[SpanRecorder] = None):
        self.recorder = recorder or SpanRecorder()
        self.prefill_s: List[float] = []
        self.decode_token_s: List[float] = []
        self.queue_wait_s: List[float] = []
        self.requests: List[RequestRecord] = []

    # ---- samples (instrument_steps feeds the first two) --------------------

    def add_prefill(self, seconds: float) -> None:
        self.prefill_s.append(float(seconds))

    def add_decode_token(self, seconds: float) -> None:
        self.decode_token_s.append(float(seconds))

    def add_request(self, request_id: int, queue_wait_s: float,
                    prefill_s: float, decode_s: float, tokens: int
                    ) -> RequestRecord:
        """One completed request (the loop computes queue wait = service
        start - arrival).  Does NOT re-add prefill/decode samples — those
        arrive per call via the instrumented steps."""
        rec = RequestRecord(request_id, queue_wait_s, prefill_s, decode_s,
                            tokens)
        self.queue_wait_s.append(float(queue_wait_s))
        self.requests.append(rec)
        return rec

    # ---- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """A `serve_summary` record body (validated by the logger)."""
        return {"kind": "serve_summary", "requests": len(self.requests),
                "queue_wait_ms": percentiles_ms(self.queue_wait_s),
                "prefill_ms": percentiles_ms(self.prefill_s),
                "decode_token_ms": percentiles_ms(self.decode_token_s)}

    def request_records(self) -> List[dict]:
        return [r.to_record() for r in self.requests]

    def log_to(self, logger) -> dict:
        """Write every per-request record + the summary to a
        `MetricsLogger`; returns the summary record."""
        for rec in self.request_records():
            logger.write(rec)
        return logger.write(self.summary())

    def format_summary(self) -> str:
        s = self.summary()

        def one(name, h):
            return (f"{name}: p50={h['p50']:.2f}ms p99={h['p99']:.2f}ms "
                    f"mean={h['mean']:.2f}ms n={h['count']}")
        return "\n".join([
            f"serve telemetry over {s['requests']} request(s)",
            "  " + one("queue_wait  ", s["queue_wait_ms"]),
            "  " + one("prefill     ", s["prefill_ms"]),
            "  " + one("decode/token", s["decode_token_ms"])])
