"""The port's telemetry plane (`repro_torch/obs/`, `launch/serve.py::
instrument_steps`) against JAX's `repro.obs`.

  - the port's records pass JAX's `validate_record` and its traces JAX's
    `validate_chrome_trace`, and the port's validators reject what JAX's
    reject;
  - `MetricsLogger`'s bias-corrected EWMA equals JAX's bit for bit and
    the port's `RateEstimator`;
  - `steptimer_timeline` gives JAX's events for the same masks;
  - `SpanRecorder`, `ServeTelemetry` and `instrument_steps` on a smoke
    serving setup; `run_metadata` and `reduce_frame`.
Tolerance: none, except the percentiles (pytest.approx of numpy's).
"""
import json
import time

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core.collectives import SignWire as JSignWire, \
    SparseWire as JSparseWire
from repro.sim import StepTimer as JStepTimer
from repro_torch import obs
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.core.coding_state import RateEstimator
from repro_torch.core.collectives import SignWire, SparseWire
from repro_torch.launch.serve import build_serve_setup, instrument_steps
from repro_torch.sim import StepTimer


def _telemetry(n=4):
    return {"participation": [1.0] * n, "participants": float(n),
            "wire_bytes_rank": [10.0] * n, "bytes_up_total": 10.0 * n,
            "bucket_wire_bytes_rank": [[10.0]] * n, "bytes_down": 8.0,
            "grad_norm_rank": [1.0] * n, "ef_norm_rank": [0.5] * n,
            "compress_cosine_rank": [0.9] * n,
            "compress_contraction_rank": [0.2] * n, "ghat_norm": 1.0,
            "update_norm": 1.0, "param_norm": 3.0}


def test_logger_records_pass_jax_validator_and_ewma(tmp_path):
    path = str(tmp_path / "m.jsonl")
    jpath = str(tmp_path / "j.jsonl")
    masks = [np.array([1.0, 0.0, 1.0, 1.0]), np.array([0.0, 1.0, 1.0, 1.0]),
             np.array([1.0, 1.0, 1.0, 0.0])]
    meta = obs.run_metadata(arch="t")
    assert {"git_sha", "torch_version", "python", "platform",
            "torch_device", "device_count", "timestamp", "arch"} <= set(meta)
    est = RateEstimator(4, alpha=0.5)
    with obs.MetricsLogger(path, run_metadata=meta, ewma_alpha=0.5) as lg, \
            jobs.MetricsLogger(jpath, ewma_alpha=0.5) as jlg:
        assert lg.rates is None
        for t, m in enumerate(masks):
            tel = _telemetry()
            tel["participation"] = m.tolist()
            lg.log_step(t, tel, loss=1.0 - 0.1 * t,
                        spans={"train/step_dispatch": 0.01})
            jlg.log_step(t, tel)
            est.update(m)
        np.testing.assert_array_equal(lg.rates, jlg.rates)
        np.testing.assert_array_equal(lg.rates, est.rates)
        lg.log_replan(2, {"epoch": 1, "drift": 0.3, "reallocated": True,
                          "rates_estimate": [0.5, 0.5, 1.0, 1.0]})
        lg.log_prefetch({"size": 2, "put_count": 3, "get_count": 3,
                         "producer_wait_s": 0.0, "consumer_wait_s": 0.1,
                         "device_put_s": 0.01, "max_depth": 2,
                         "depth_sum": 4})
    recs = obs.read_jsonl(path)
    assert [r["kind"] for r in recs] == ["run_meta"] + ["train_step"] * 3 \
        + ["replan", "prefetch"]
    for r in recs:
        jobs.validate_record(r)
        obs.validate_record(r)
    for bad in ({"kind": "train_step", "schema": obs.SCHEMA},
                {**recs[1], "grad_norm_rank": [1.0]},
                {**recs[1], "schema": "repro.obs/v0"}, "not a dict"):
        for validate in (jobs.validate_record, obs.validate_record):
            with pytest.raises(ValueError):
                validate(bad)
    with pytest.raises(ValueError):
        obs.MetricsLogger(str(tmp_path / "x.jsonl")).write({"kind": "nope"})


def test_spans_and_chrome_trace_pass_jax_validator(tmp_path):
    rec = obs.SpanRecorder()
    with rec.span("phase/a", step=0):
        time.sleep(0.01)
    with rec.span("phase/b", tid="serve"):
        pass
    with obs.scope("phase/c"):
        pass
    rec.counter("queue_depth", 2)
    assert rec.durations("phase/a")[0] >= 0.01
    assert set(rec.summary_s()) == {"phase/a", "phase/b"}
    path = str(tmp_path / "trace.json")
    o = obs.write_chrome_trace(path, obs.span_events(
        rec.spans, pid=0, counters=rec.counters), metadata={"arch": "t"})
    loaded = json.load(open(path))
    for validate in (jobs.validate_chrome_trace, obs.validate_chrome_trace):
        validate(o)
        validate(loaded)
    kinds = [e["ph"] for e in loaded["traceEvents"]]
    assert kinds.count("X") == 2 and kinds.count("C") == 1
    bad = obs.chrome_trace([{"name": "x", "ph": "Z", "ts": 0.0, "dur": 1.0,
                             "pid": 0, "tid": "t"}])
    for validate in (jobs.validate_chrome_trace, obs.validate_chrome_trace):
        with pytest.raises(ValueError):
            validate(bad)


@pytest.mark.parametrize("wire,jwire,kw", [
    (SignWire(512), JSignWire(group_size=512), {}),
    (SignWire(512), JSignWire(group_size=512),
     {"num_buckets": 4, "overlap": True}),
    (SparseWire((2, 4, 8, 16), 512), JSparseWire(k_per_block=(2, 4, 8, 16),
                                                 block_size=512), {})],
    ids=["sign", "sign-pipelined", "budgets"])
def test_steptimer_timeline_equals_jax(wire, jwire, kw):
    n = 1 << 20
    rng = np.random.default_rng(0)
    trace = (rng.random((6, 4)) > 0.3).astype(np.float64)
    trace[2] = 0.0                                     # all straggle
    ev, t = obs.steptimer_timeline(StepTimer(wire=wire, n=n, **kw), trace)
    jev, jt = jobs.steptimer_timeline(JStepTimer(wire=jwire, n=n, **kw),
                                      trace)
    assert ev == jev
    np.testing.assert_array_equal(t, jt)
    jobs.validate_chrome_trace(obs.chrome_trace(ev))


def test_reduce_frame_and_frame_to_host():
    f = obs.MetricsFrame.zeros(2, 2, 1, "cpu")
    f.participation = torch.tensor([1.0, 0.0], dtype=torch.float64)
    f.acc_norm_sq = torch.tensor([4.0, 0.0], dtype=torch.float64)
    f.c_norm_sq = torch.tensor([1.0, 0.0], dtype=torch.float64)
    f.acc_dot_c = torch.tensor([2.0, 0.0], dtype=torch.float64)
    f.ghat_norm_sq = torch.tensor(9.0, dtype=torch.float64)
    h = obs.frame_to_host(obs.reduce_frame(f))
    assert h["compress_cosine_rank"] == [1.0, 0.0]     # 2 / (2 * 1); 0/0
    assert h["compress_contraction_rank"] == [0.25, 0.0]
    assert h["ghat_norm"] == 3.0 and h["participants"] == 1.0
    assert obs.norm_sq(torch.arange(5.0), chunk=2).item() == 30.0


def test_instrument_steps_feeds_serve_telemetry(tmp_path):
    setup = build_serve_setup(REGISTRY["gemma2-2b"], ShapeCfg("prefill", 16, 2),
                              smoke=True, device="cpu")
    setup.model.init_(0)
    tel = obs.ServeTelemetry()
    prefill, decode = instrument_steps(setup, tel)
    logits, caches = prefill(torch.zeros((2, 16), dtype=torch.long))
    for pos in range(16, 19):
        logits, caches = decode(caches, logits.argmax(-1)[:, None], pos)
    want, _ = setup.prefill_step(torch.zeros((2, 16), dtype=torch.long))
    assert len(tel.prefill_s) == 1 and len(tel.decode_token_s) == 3
    assert [s["name"] for s in tel.recorder.spans] == \
        ["serve/prefill"] + ["serve/decode"] * 3
    tel.add_request(0, queue_wait_s=0.01, prefill_s=tel.prefill_s[0],
                    decode_s=sum(tel.decode_token_s), tokens=3)
    s = tel.summary()
    assert s["decode_token_ms"]["count"] == 3
    assert s["decode_token_ms"]["p50"] == pytest.approx(
        np.percentile(np.asarray(tel.decode_token_s) * 1e3, 50))
    with obs.MetricsLogger(str(tmp_path / "s.jsonl")) as lg:
        tel.log_to(lg)
    for r in obs.read_jsonl(str(tmp_path / "s.jsonl")):
        jobs.validate_record(r)
    assert torch.isfinite(logits).all()
