"""Step-level telemetry (port of `repro.obs`): the train step's metrics
frame, span tracing, Chrome-trace export and serve telemetry.

  metrics       MetricsFrame filled by the step (`TrainRun(metrics=True)`)
                and its reduction to per-rank step metrics
  logger        MetricsLogger JSONL sink (schema repro.obs/v1), EWMA
                per-rank participation rates, record validation,
                run_metadata
  tracing       NVTX scopes + host-side SpanRecorder
  trace_export  Chrome-trace JSON for measured spans and simulated
                sim.StepTimer schedules (serial + pipelined buckets)
  serving       ServeTelemetry: queue wait + prefill/decode p50/p99
"""
from .logger import (MetricsLogger, SCHEMA, percentiles_ms, read_jsonl,
                     run_metadata, validate_record)
from .metrics import MetricsFrame, frame_to_host, norm_sq, reduce_frame
from .serving import RequestRecord, ServeTelemetry
from .trace_export import (chrome_trace, span_events, steptimer_timeline,
                           validate_chrome_trace, write_chrome_trace)
from .tracing import SpanRecorder, scope

__all__ = [
    "MetricsFrame", "frame_to_host", "norm_sq", "reduce_frame",
    "MetricsLogger", "SCHEMA", "percentiles_ms", "read_jsonl",
    "run_metadata", "validate_record",
    "SpanRecorder", "scope",
    "chrome_trace", "span_events", "steptimer_timeline",
    "validate_chrome_trace", "write_chrome_trace",
    "ServeTelemetry", "RequestRecord",
]
