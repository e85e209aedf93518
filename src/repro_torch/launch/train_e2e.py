"""End-to-end driver: COCO-EF training of a transformer LM with its coding
plane and checkpoint/restart (port of `examples/train_e2e.py`).

    PYTHONPATH=src python -m repro_torch.launch.train_e2e [--steps 60]
        [--device cpu]

The run of JAX's driver: the smoke config of `--arch`, seq 64, global batch
16, 4 coding ranks (here all on one device), the coding overrides group 32,
block 64, k 8, base_lr 5e-3 in cocoef mode; its flags, defaults and
messages.  Checkpoints are JAX's format (`repro_torch.checkpoint`): a
checkpoint of either package resumes in the other.  A rerun with a higher
`--steps` resumes from the latest checkpoint in `--ckpt-dir` and continues
bit for bit, except under `--elastic`: as in JAX's driver, the checkpoint
holds no coding plane, so a resumed elastic run restarts its rate
estimator and its allocation at epoch 0 and trains on other batches than
an uninterrupted one.  `run()` is the loop, which `chip_smoke.py` drives
at full width.

`--plan auto` runs the sim planner (`sim.planner.plan_search`, its
confirmation on the run's device) over the run's straggler process, prints
its ranking, writes the emission to `--plan-out` and trains the winner.
`--prefetch N` stages N batches ahead on a host thread (pinned buffers,
non-blocking copies on a side stream; the same batches, bit for bit).
`--metrics` makes the step return its telemetry frame and writes
`metrics.jsonl` (schema repro.obs/v1) and a Chrome trace `trace.json`
(measured host spans beside the StepTimer's predicted schedule for the
observed masks) under `--metrics-dir`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import REGISTRY
from repro_torch.configs.common import ArchSpec, ShapeCfg
from repro_torch.core import prng
from repro_torch.core.coding_state import RateEstimator
from repro_torch.core.plan import PLAN_SCHEMA, PlanSpec
from repro_torch.launch.train import (TrainRun, batch_stream,
                                      build_train_setup, elastic_coding_state)
from repro_torch.obs import (MetricsLogger, SpanRecorder, frame_to_host,
                             run_metadata, span_events, steptimer_timeline,
                             write_chrome_trace)
from repro_torch.sim import (LinkProfile, MarkovBursty, StepTimer,
                             TraceReplay, get_straggler_process, plan_search,
                             solve_k_budgets)

N_CODE = 4                # the coding ranks of JAX's (pod=2, data=2) mesh
SHAPE = ShapeCfg("train", seq_len=64, global_batch=16)
CODING_OVERRIDES = dict(group_size=32, block_size=64, k_per_block=8)
BUDGET_N = 1 << 16        # flat size the per-rank budgets are solved at
PLAN_N_WIRE = 1 << 16     # flat size the auto-planner prices wires at


class UsageError(ValueError):
    """A flag or a combination of flags the run cannot take."""


def _tmp(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def _prob(s):
    v = float(s)
    if not 0.0 <= v < 1.0:
        raise argparse.ArgumentTypeError(
            f"straggle probability {v} must be in [0, 1)")
    return v


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train_e2e",
        description="COCO-EF training with checkpoint/restart (the "
                    "PyTorch port of examples/train_e2e.py)")
    ap.add_argument("--arch", default="olmoe-1b-7b", choices=sorted(REGISTRY),
                    help="architecture (its smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the run lives on (cuda, or cpu for "
                         "the plain PyTorch versions of the kernels)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--compressor", default="sign",
                    choices=["sign", "block_topk", "topk", "identity"],
                    help="phase-1 wire compressor (WireFormat selection)")
    ap.add_argument("--num-buckets", type=int, default=1,
                    help="flat-vector buckets for comm overlap")
    ap.add_argument("--bucket-schedule", default="pipelined",
                    choices=["pipelined", "serial"],
                    help="per-bucket collective issue order: pipelined "
                         "finishes bucket i after bucket i+1's local step "
                         "was issued (bit-for-bit equal to serial)")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="host->device batches staged ahead of the step "
                         "by a background thread (0 = synchronous; the "
                         "same batches either way)")
    ap.add_argument("--straggler", default="iid",
                    choices=["iid", "markov", "hetero", "trace"],
                    help="straggler process driving the per-step "
                         "participation masks (repro_torch.sim)")
    ap.add_argument("--straggler-p", type=_prob, default=None,
                    help="override the arch's Bernoulli/stationary "
                         "straggle probability (in [0, 1))")
    ap.add_argument("--straggler-burst", type=float, default=8.0,
                    help="markov: mean slow-burst length in steps (>= 1)")
    ap.add_argument("--straggler-spread", type=float, default=0.5,
                    help="hetero: per-rank p_i in p*(1 +/- spread), every "
                         "p_i must land in [0, 1)")
    ap.add_argument("--straggler-trace", default=None,
                    help="recorded-mask JSON for --straggler trace "
                         "(default: synthesize a bursty trace and save it)")
    ap.add_argument("--elastic", action="store_true",
                    help="dynamic coding plane: a live CodingState (rate "
                         "estimates + encode weights) rides the step; masks "
                         "observed on the host feed an online "
                         "RateEstimator, drift past --replan-threshold "
                         "regenerates the allocation mid-run (epoch bump)")
    ap.add_argument("--replan-threshold", type=float, default=0.1,
                    help="elastic: max |q_est - q_planned| tolerated "
                         "before rate_aware_allocation is re-run")
    ap.add_argument("--mean-rate-coding", action="store_true",
                    help="encode weights from the scalar mean rate p "
                         "(paper eq. 3) instead of the per-rank rates "
                         "q_i of the straggler process (rate-aware, "
                         "unbiased under non-iid stragglers; the default)")
    ap.add_argument("--rank-uplink-gbps", default=None,
                    help="comma-separated per-coding-rank uplink Gbit/s; "
                         "with --compressor block_topk, solves equal-time "
                         "per-rank wire budgets (sim.solve_k_budgets) so "
                         "slow-uplink ranks send fewer coords per block")
    ap.add_argument("--plan", default=None,
                    help="'auto' runs the sim planner (enumerate -> "
                         "analytic prune -> simulated confirm) over this "
                         "run's straggler profile, prints the ranking, and "
                         "trains the winner; a path loads a saved PlanSpec "
                         "JSON (PlanSpec.save or a planner emission). "
                         "Overrides --compressor/--num-buckets/"
                         "--bucket-schedule")
    ap.add_argument("--plan-out", default=_tmp("repro_torch_e2e_plan.json"),
                    help="where --plan auto writes the winner + ranking + "
                         "run_metadata provenance JSON")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=_tmp("repro_torch_e2e_ckpt"))
    ap.add_argument("--metrics", action="store_true",
                    help="step-level telemetry (repro_torch.obs): the "
                         "step's MetricsFrame -> JSONL metrics + a Chrome "
                         "trace of measured host spans alongside the "
                         "StepTimer-PREDICTED schedule for the observed "
                         "masks")
    ap.add_argument("--metrics-dir", default=_tmp("repro_torch_e2e_metrics"),
                    help="where --metrics writes metrics.jsonl + trace.json")
    return ap


def _load_plan(path: str) -> PlanSpec:
    """A saved plan: a bare PlanSpec JSON (PlanSpec.save) or a planner
    emission whose "plan" field carries the winning spec."""
    obj = json.loads(Path(path).read_text())
    if isinstance(obj, dict) and obj.get("schema") != PLAN_SCHEMA \
            and "plan" in obj:
        obj = obj["plan"]
    return PlanSpec.from_dict(obj)


def _driver_spec(args, spec: ArchSpec) -> ArchSpec:
    over = dict(CODING_OVERRIDES)
    if args.straggler_p is not None:
        over["straggler_p"] = args.straggler_p
    return dataclasses.replace(
        spec, coding=dataclasses.replace(spec.coding, **over))


def _trace_path(args, spec: ArchSpec) -> Optional[str]:
    """--straggler-trace, or for --straggler trace without one a bursty
    trace synthesised from seed 42 and saved (JAX's demo trace)."""
    if args.straggler != "trace" or args.straggler_trace is not None:
        return args.straggler_trace
    p = spec.coding.straggler_p
    if args.straggler_p is None and p == 0:
        p = 0.2   # demo default; an explicit --straggler-p 0.0 stands
    proc = MarkovBursty(num_devices=N_CODE, p=p, mean_burst=6.0)
    trace = TraceReplay.from_array(proc.sample_trace(42, 128))
    path = str(trace.to_json(_tmp("repro_torch_e2e_trace.json")))
    print(f"synthesized bursty trace -> {path}")
    return path


def _auto_plan(args, spec: ArchSpec, n_code: int, trace_path,
               plan_out: str) -> PlanSpec:
    """`--plan auto`: the three-stage sim planner over this run's
    straggler profile (its confirmation on args.device); prints the
    ranking, writes the emission (winner + ranking + provenance) and
    returns the winner."""
    p = spec.coding.straggler_p
    if args.straggler != "iid" or p > 0:
        proc = get_straggler_process(
            args.straggler, n_code, p, mean_burst=args.straggler_burst,
            spread=args.straggler_spread, trace=trace_path)
        res = plan_search(PLAN_N_WIRE, process=proc, confirm_steps=120,
                          seed=0, device=args.device)
    else:       # fully reliable fleet: rates-only search, no masks to sim
        res = plan_search(PLAN_N_WIRE, rates=np.ones((n_code,)),
                          confirm_steps=120, seed=0, device=args.device)
    print(f"planner: {res.num_enumerated} candidates -> "
          f"{res.pruned_to} confirmed; ranking:")
    for c in res.candidates[:res.pruned_to]:
        t2t = (f"{c.sim_time_to_target_s:.3f}s"
               if c.sim_time_to_target_s is not None else "never")
        print(f"  d={c.plan.d} {c.plan.compressor:10s} "
              f"alloc={c.plan.allocation:10s} score={c.score:.4f} "
              f"sim-t2t={t2t}")
    emission = {**res.to_dict(),
                "plan": res.best.plan.to_dict(),
                "meta": run_metadata(
                    arch=args.arch, straggler=args.straggler,
                    straggler_p=p, n_code=n_code, n_wire=PLAN_N_WIRE)}
    Path(plan_out).parent.mkdir(parents=True, exist_ok=True)
    Path(plan_out).write_text(json.dumps(emission, indent=1) + "\n")
    print(f"plan emission -> {plan_out}")
    return res.best.plan


def _train_run(args, spec: ArchSpec, trace_path) -> TrainRun:
    if args.prefetch < 0:
        raise UsageError(f"--prefetch {args.prefetch} must be >= 0")
    k_budgets = None
    if args.rank_uplink_gbps:
        if args.compressor != "block_topk":
            raise UsageError("--rank-uplink-gbps needs --compressor "
                             "block_topk (per-rank budgets ride the sparse "
                             "wire)")
        bws = tuple(float(b) for b in args.rank_uplink_gbps.split(","))
        link = LinkProfile(rank_bandwidth_gbps=bws)
        k_budgets = solve_k_budgets(
            BUDGET_N, len(bws), link, block_size=spec.coding.block_size,
            k_ref=spec.coding.k_per_block)
        print(f"per-rank wire budgets (equal-time): k={k_budgets} for "
              f"uplinks {bws} Gbit/s")
    plan = None
    if args.plan:
        if k_budgets is not None:
            raise UsageError("--rank-uplink-gbps solves k_budgets, which "
                             "conflicts with an explicit --plan (per-rank "
                             "budgets live in the plan's k_per_block)")
        plan = (_auto_plan(args, spec, N_CODE, trace_path, args.plan_out)
                if args.plan == "auto" else _load_plan(args.plan))
        print(f"plan: d={plan.d} compressor={plan.compressor} "
              f"alloc={plan.allocation} buckets={plan.num_buckets} "
              f"({plan.bucket_schedule})")
    wire_kw = (dict(plan=plan) if plan is not None else
               dict(compressor=args.compressor,
                    num_buckets=args.num_buckets,
                    bucket_schedule=args.bucket_schedule,
                    k_budgets=k_budgets))
    return TrainRun(base_lr=5e-3, mode="cocoef", prefetch=args.prefetch,
                    straggler=args.straggler,
                    straggler_burst=args.straggler_burst,
                    straggler_spread=args.straggler_spread,
                    straggler_trace=trace_path,
                    rate_aware=not args.mean_rate_coding,
                    elastic=args.elastic,
                    replan_threshold=args.replan_threshold,
                    metrics=args.metrics, **wire_kw)


def elastic_tick(setup, estimator: RateEstimator, mask: torch.Tensor):
    """One tick of the elastic coding plane after a step: fold the mask
    the step used into the estimator, then `elastic_coding_state` on its
    rates.  Returns (the CodingState of the next step, the replan info)."""
    estimator.update(mask.cpu().numpy())
    return elastic_coding_state(setup, estimator.rates)


def run(args, spec: Optional[ArchSpec] = None,
        shape: Optional[ShapeCfg] = None, smoke: bool = True) -> dict:
    """Train from the latest checkpoint in args.ckpt_dir (or from scratch)
    up to args.steps, checkpointing every args.ckpt_every steps.  spec
    (default REGISTRY[args.arch]) gets the driver's coding overrides;
    shape defaults to JAX's driver shape; smoke picks spec.smoke.
    Raises UsageError for flags the run cannot take.  Returns {"setup",
    "e", "start", "steps": one record per step (loss, step_s (host clock,
    ending in a synchronise), kernel_ms and kernel_spans_ms (stage 2's
    CUDA event spans: each rank's local step, then the decode; 0 and []
    on the CPU), batch_s (the host's time to wait for the batch: to make
    it, or with --prefetch to take it from the queue), mask, weights,
    allocation, under --elastic the replan info and plane_s (the host's
    time for the estimator and the replan tick), in the MoE family
    moe_dropped (each rank's assignments over capacity)), "ckpt": one
    record per save (step, path, bytes, save_s), "init_s" (theta0 and
    e's allocation, synchronised), "restore_s" (None without a resume),
    "prefetch" (the PrefetchStats snapshot, None without --prefetch),
    and under --metrics "metrics" (jsonl and trace paths,
    batch_wait_s per step, the StepTimer's predicted_step_s)}."""
    spec = _driver_spec(args, spec or REGISTRY[args.arch])
    shape = shape or SHAPE
    trace_path = _trace_path(args, spec)
    try:
        run_cfg = _train_run(args, spec, trace_path)
        setup = build_train_setup(spec, shape, run_cfg, smoke=smoke,
                                  n_code=N_CODE, device=args.device)
    except UsageError:
        raise
    except ValueError as err:      # bad straggler/coding knobs fail HERE
        raise UsageError(str(err)) from err
    proc = setup.straggler_process
    coding = ("mean-rate p" if setup.straggler_rates is None
              else "rate-aware q_i")
    print(f"arch={args.arch} coding ranks={setup.n_code} "
          f"per-rank batch={setup.b_loc} local flat={setup.flat_pad} "
          f"straggler={type(proc).__name__ if proc else 'none'} "
          f"coding={coding}")

    estimator = state = None
    if args.elastic:
        estimator = RateEstimator(setup.n_code)
        state, _ = elastic_coding_state(setup)   # epoch 0: planned rates
        print(f"elastic coding plane: replan threshold "
              f"{args.replan_threshold}, epoch 0 rates "
              f"{[round(float(x), 3) for x in state.rates_estimate]}")

    t0 = time.perf_counter()
    e = setup.init_state(prng.PRNGKey(0))   # JAX driver: PRNGKey(0)
    _sync(setup.device)
    out = {"setup": setup, "e": e, "start": 0, "steps": [], "ckpt": [],
           "restore_s": None, "init_s": time.perf_counter() - t0}

    def ckpt_state():
        return {"params": setup.model.params(),
                "e": e.view(setup.n_code, 1, -1)}

    if latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        out["start"], _ = restore_checkpoint(args.ckpt_dir, ckpt_state())
        _sync(setup.device)
        out["restore_s"] = time.perf_counter() - t0
        print(f"resumed from step {out['start']}")

    logger = rec = None
    masks = []
    if args.metrics:
        meta = run_metadata(
            arch=args.arch, steps=args.steps, seed=run_cfg.seed,
            mode=run_cfg.mode, compressor=setup.plan.compressor,
            num_buckets=setup.plan.num_buckets,
            bucket_schedule=setup.plan.bucket_schedule,
            backend_requested=setup.plan.backend,
            plan=setup.plan.to_dict(), straggler=args.straggler,
            straggler_p=spec.coding.straggler_p, prefetch=args.prefetch,
            rate_aware=run_cfg.rate_aware, n_code=setup.n_code,
            flat_pad=setup.flat_pad, device=str(setup.device))
        logger = MetricsLogger(str(Path(args.metrics_dir) / "metrics.jsonl"),
                               run_metadata=meta)
        rec = SpanRecorder()
    span = rec.span if rec is not None else _no_span
    # staged --prefetch steps ahead by the background prefetcher while the
    # card runs the current step
    batches = batch_stream(setup, start_step=out["start"],
                           prefetch=run_cfg.prefetch)
    try:
        for t in range(out["start"], args.steps):
            t0 = time.perf_counter()
            with span("train/batch_wait", step=t):
                batch = next(batches)
            batch_s = time.perf_counter() - t0
            if rec is not None and batches.stats is not None:
                rec.counter("prefetch_depth", batches.stats.max_depth)
            spans = []
            t0 = time.perf_counter()
            with span("train/step_dispatch", step=t):
                m = setup.train_step(setup.model, e, batch, t,
                                     kernel_spans=spans, coding_state=state)
            with span("train/result_fetch", step=t):
                loss = m["loss"].item()
                tel = (frame_to_host(m["telemetry"]) if rec is not None
                       else None)
                _sync(setup.device)
            span_ms = [a.elapsed_time(b) for a, b in spans]
            rec_t = {"step": t, "loss": loss,
                     "step_s": time.perf_counter() - t0,
                     "kernel_ms": sum(span_ms), "kernel_spans_ms": span_ms,
                     "batch_s": batch_s,
                     "mask": m["mask"].tolist(),
                     "weights": m["weights"].tolist(),
                     "allocation": (setup.coding_plan
                                    or setup).allocation.S.tolist()}
            if "moe_dropped" in m:
                rec_t["moe_dropped"] = m["moe_dropped"].tolist()
            if rec is not None:
                span_s = {x["name"]: x["t1"] - x["t0"]
                          for x in rec.spans[-3:]}
                logger.log_step(t, tel, loss=loss, spans=span_s)
                masks.append(tel["participation"])
            if args.elastic:
                t0 = time.perf_counter()
                state, info = elastic_tick(setup, estimator, m["mask"])
                rec_t["replan"] = info
                rec_t["plane_s"] = time.perf_counter() - t0
                if logger is not None:
                    logger.log_replan(t, info)
                if info["reallocated"]:
                    print(f"  replan @ step {t}: drift={info['drift']:.3f}"
                          f" -> allocation epoch {info['epoch']}")
            out["steps"].append(rec_t)
            if t % 10 == 0 or t == args.steps - 1:
                print(f"step {t:4d} loss={loss:.4f}")
            if (t + 1) % args.ckpt_every == 0:
                t0 = time.perf_counter()
                p = save_checkpoint(args.ckpt_dir, t + 1, ckpt_state())
                out["ckpt"].append({"step": t + 1, "path": str(p),
                                    "bytes": p.stat().st_size,
                                    "save_s": time.perf_counter() - t0})
                print(f"  checkpointed -> {p.name}")
    finally:
        if logger is not None and batches.stats is not None:
            logger.log_prefetch(batches.stats.snapshot())
        batches.close()     # stop and join the prefetch worker
    out["prefetch"] = (batches.stats.snapshot() if batches.stats is not None
                       else None)
    if rec is not None:
        out["metrics"] = _write_trace(args, setup, rec, logger, masks, meta)
    return out


def _write_trace(args, setup, rec: SpanRecorder, logger: MetricsLogger,
                 masks, meta) -> dict:
    """Chrome trace: measured host spans (pid 0) + the StepTimer
    PREDICTION for the same observed masks (pid 1), priced on the
    setup's own PlanSpec."""
    plan = setup.plan
    wire = plan.wire(setup.flat_pad // plan.num_buckets, 1)
    timer = StepTimer(wire=wire, n=setup.flat_pad,
                      num_buckets=plan.num_buckets, overlap=plan.overlap)
    sim_ev, sim_t = steptimer_timeline(timer, np.asarray(masks, np.float64),
                                       pid=1)
    events = span_events(rec.spans, pid=0, counters=rec.counters) + sim_ev
    tpath = str(Path(args.metrics_dir) / "trace.json")
    write_chrome_trace(tpath, events, metadata=meta)
    logger.close()
    print(f"telemetry -> {logger.path} ({logger.steps_logged} steps); "
          f"trace -> {tpath}")
    print(f"EWMA participation rates: "
          f"{[round(float(x), 3) for x in logger.rates]}")
    print(f"StepTimer-predicted mean step: {sim_t.mean()*1e3:.2f} ms "
          f"(simulated link; measured host spans in the trace)")
    return {"jsonl": logger.path, "trace": tpath,
            "batch_wait_s": rec.durations("train/batch_wait"),
            "predicted_step_s": sim_t.tolist()}


@contextlib.contextmanager
def _no_span(name: str, **args):
    yield


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        run(args)
    except UsageError as err:
        ap.error(str(err))


if __name__ == "__main__":
    main()
