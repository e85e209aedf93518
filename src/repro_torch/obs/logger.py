"""Host-side metrics sink: schema-versioned JSONL + rolling aggregates
(the port's copy of `repro.obs.logger`; JSON records equal JAX's).

`MetricsLogger` drains reduced `MetricsFrame`s (see `repro_torch.obs.metrics`)
into an append-only JSONL file.  Every line is a
self-describing record carrying `schema` + `kind`; `validate_record`
enforces the per-kind required fields (the CI metrics-smoke job and the
tests run every emitted line through it).

Record kinds (schema `repro.obs/v1`):

  run_meta      {"meta": {...}}                — provenance, first line
                (git sha / torch version / knobs via `run_metadata`,
                the port's copy of `benchmarks._repro_common.run_metadata`)
  train_step    per-step telemetry: the reduced frame fields
                (participation, wire_bytes_rank, norms, cosine, ...) plus
                "step", "t_wall_s", "ewma_participation" and optional
                host-span durations under "spans"
  serve_request one served request (queue wait / prefill / decode)
  serve_summary latency histogram summary (p50/p99, queue wait)
  prefetch      a `data.pipeline.PrefetchStats` snapshot
  replan        one coding-plane control tick (`CodingPlan.maybe_replan`):
                epoch / drift / reallocated / rates_estimate

The logger also maintains the bias-corrected per-rank EWMA participation
rates over the observed masks — the online rate estimate ROADMAP item 4
needs as input (`MetricsLogger.rates` feeds
`core.coding_state.CodingPlan.maybe_replan`, which refits
`coding.encode_weights` and re-allocates on drift).  The correction is
implemented inline (not via `core.coding_state.RateEstimator`), as in
JAX's; the two give the same bits.
"""
from __future__ import annotations

import json
import numbers
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, IO, Iterable, List, Optional

import numpy as np

__all__ = ["SCHEMA", "MetricsLogger", "validate_record", "read_jsonl",
           "percentiles_ms", "run_metadata"]

SCHEMA = "repro.obs/v1"

_KINDS = ("run_meta", "train_step", "serve_request", "serve_summary",
          "prefetch", "replan")

# required per-kind fields and their coarse types (beyond schema/kind)
_REQUIRED = {
    "run_meta": {"meta": dict},
    "train_step": {"step": numbers.Number, "t_wall_s": numbers.Number,
                   "participation": list, "participants": numbers.Number,
                   "wire_bytes_rank": list, "bytes_up_total": numbers.Number,
                   "bytes_down": numbers.Number,
                   "ewma_participation": list,
                   "grad_norm_rank": list, "ef_norm_rank": list,
                   "compress_cosine_rank": list,
                   "compress_contraction_rank": list,
                   "ghat_norm": numbers.Number,
                   "update_norm": numbers.Number},
    "serve_request": {"request_id": numbers.Number,
                      "queue_wait_s": numbers.Number,
                      "prefill_s": numbers.Number,
                      "decode_s": numbers.Number,
                      "tokens": numbers.Number},
    "serve_summary": {"requests": numbers.Number,
                      "queue_wait_ms": dict, "prefill_ms": dict,
                      "decode_token_ms": dict},
    "prefetch": {"stats": dict},
    "replan": {"step": numbers.Number, "epoch": numbers.Number,
               "drift": numbers.Number, "reallocated": bool,
               "rates_estimate": list},
}

_HIST_KEYS = ("p50", "p99", "mean", "count")


def validate_record(rec: dict) -> None:
    """Raise ValueError unless `rec` is a well-formed schema-v1 record."""
    if not isinstance(rec, dict):
        raise ValueError(f"record must be a dict, got {type(rec).__name__}")
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"record schema {rec.get('schema')!r} != {SCHEMA!r}")
    kind = rec.get("kind")
    if kind not in _KINDS:
        raise ValueError(f"unknown record kind {kind!r}; have {_KINDS}")
    for field, typ in _REQUIRED[kind].items():
        if field not in rec:
            raise ValueError(f"{kind} record missing field {field!r}")
        if not isinstance(rec[field], typ):
            raise ValueError(
                f"{kind}.{field} must be {typ.__name__}, got "
                f"{type(rec[field]).__name__}")
    if kind == "train_step":
        n = len(rec["participation"])
        for field in ("wire_bytes_rank", "ewma_participation",
                      "grad_norm_rank", "ef_norm_rank",
                      "compress_cosine_rank", "compress_contraction_rank"):
            if len(rec[field]) != n:
                raise ValueError(f"train_step.{field} has "
                                 f"{len(rec[field])} entries, expected {n}")
    if kind == "serve_summary":
        for field in ("queue_wait_ms", "prefill_ms", "decode_token_ms"):
            missing = [k for k in _HIST_KEYS if k not in rec[field]]
            if missing:
                raise ValueError(f"serve_summary.{field} missing "
                                 f"histogram keys {missing}")


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _to_plain(v):
    a = np.asarray(v)
    if a.dtype == object:
        return v
    return a.tolist() if a.ndim else float(a)


class MetricsLogger:
    """Append-only JSONL sink + EWMA participation aggregator.

    ewma_alpha: weight of the newest mask in the per-rank participation
    EWMA (`rates`), the online estimate of q_i = P[rank i participates].
    Every record is validated before it is written, so a schema drift
    fails at the producer, not in some later reader.
    """

    def __init__(self, path: str, *, run_metadata: Optional[dict] = None,
                 ewma_alpha: float = 0.1):
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError(f"ewma_alpha={ewma_alpha} must be in (0, 1]")
        self.path = path
        self.ewma_alpha = float(ewma_alpha)
        self._ewma: Optional[np.ndarray] = None
        self._steps = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: Optional[IO[str]] = open(path, "w")
        if run_metadata is not None:
            self.write({"kind": "run_meta", "meta": dict(run_metadata)})

    # ---- low-level ---------------------------------------------------------

    def write(self, rec: dict) -> dict:
        """Stamp schema, validate, append one JSONL line; returns the
        record as written."""
        rec = {"schema": SCHEMA, **rec}
        validate_record(rec)
        if self._f is None:
            raise ValueError(f"MetricsLogger({self.path}) is closed")
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    # ---- train path --------------------------------------------------------

    def log_step(self, step: int, telemetry: Dict[str, object],
                 loss: Optional[float] = None,
                 spans: Optional[Dict[str, float]] = None,
                 t_wall_s: Optional[float] = None) -> dict:
        """One reduced `MetricsFrame` (see `metrics.reduce_frame_grid`) ->
        one train_step record; updates the participation EWMA."""
        tel = {k: _to_plain(v) for k, v in telemetry.items()}
        mask = np.asarray(tel["participation"], np.float64)
        a = self.ewma_alpha
        if self._ewma is None:
            self._ewma = np.zeros_like(mask)
        # zero-init accumulator + Adam-style bias correction (divide by
        # 1 - (1-a)^t): the reported estimate is an exact weighted average
        # of the masks seen so far.  Seeding from the first mask instead
        # left early estimates dominated by step-0 noise for ~1/a steps.
        self._ewma = (1.0 - a) * self._ewma + a * mask
        self._steps += 1
        rec = {"kind": "train_step", "step": int(step),
               "t_wall_s": float(t_wall_s if t_wall_s is not None
                                 else time.time()),
               "ewma_participation": self._corrected().tolist(), **tel}
        if loss is not None:
            rec["loss"] = float(loss)
        if spans:
            rec["spans"] = {k: float(v) for k, v in spans.items()}
        return self.write(rec)

    def _corrected(self) -> np.ndarray:
        # np.power, NOT python **: the two differ in the last ulp and this
        # must match core.coding_state.RateEstimator bit-for-bit
        corr = 1.0 - np.power(1.0 - self.ewma_alpha, float(self._steps))
        return self._ewma / corr

    @property
    def rates(self) -> Optional[np.ndarray]:
        """(N,) bias-corrected EWMA per-rank participation rates over the
        logged steps — the online q_i estimate that feeds
        `core.coding_state.CodingPlan.maybe_replan` (ROADMAP item 4).
        None before the first step."""
        return None if self._ewma is None else self._corrected()

    def log_replan(self, step: int, info: Dict[str, object]) -> dict:
        """One `CodingPlan.maybe_replan` host event -> a replan record
        (epoch / drift / reallocated / rates_estimate)."""
        return self.write({"kind": "replan", "step": int(step),
                           "epoch": int(info["epoch"]),
                           "drift": float(info["drift"]),
                           "reallocated": bool(info["reallocated"]),
                           "rates_estimate":
                               [float(x) for x in info["rates_estimate"]]})

    @property
    def steps_logged(self) -> int:
        return self._steps

    # ---- other planes ------------------------------------------------------

    def log_prefetch(self, stats: Dict[str, object]) -> dict:
        return self.write({"kind": "prefetch", "stats": dict(stats)})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def percentiles_ms(samples_s: Iterable[float]) -> Dict[str, float]:
    """Latency histogram summary in milliseconds: p50/p99/mean/count
    (the serve_summary building block)."""
    xs = np.asarray(list(samples_s), np.float64) * 1e3
    if xs.size == 0:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "count": 0}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)),
            "mean": float(xs.mean()), "count": int(xs.size)}


def run_metadata(**knobs) -> dict:
    """Provenance stamp of a run (the port's copy of
    `benchmarks/_repro_common.run_metadata`, with torch's facts in place
    of JAX's): git sha (None outside a git checkout), torch and CUDA
    versions, python, platform, the device kind and count, a UTC
    timestamp, plus the caller's knobs."""
    import torch
    sha = None
    try:
        r = subprocess.run(["git", "rev-parse", "HEAD"],
                           cwd=Path(__file__).resolve().parents[3],
                           capture_output=True, text=True, timeout=10)
        if r.returncode == 0:
            sha = r.stdout.strip()
    except Exception:
        pass
    cuda = torch.cuda.is_available()
    meta = {
        "git_sha": sha,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch_device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    meta.update(knobs)
    return meta
