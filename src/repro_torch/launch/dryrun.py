"""The production-mesh dry run of the port over every (arch, shape, mesh)
cell (counterpart of `repro.launch.dryrun`), with nothing allocated and
nothing run on a card.

For each cell it records what one device of JAX's production mesh
((data=16, model=16), or (pod=2, data=16, model=16)) would hold and do:

  arguments  `train_specs` / `serve_specs`: every argument leaf of the
             step with its global shape, dtype, spec (`sharding.rules`)
             and per-device shard shape, JAX's `input_specs` leaf for
             leaf (JAX's dtypes: int32 tokens); `memory.argument_bytes`
             sums one device's shards.
  stage 1    the full-width model built on the meta device and one coding
             rank's stage 1 (forward and backward with the port's remat)
             at (b_loc, seq), or one prefill or decode step, run under
             `op_cost.OpCounter`: its dot flops, eager bytes and kernel
             charges (B8's, on the meta device), in `cost.stage1`.
             `flops_ideal_per_device` is that count over the devices that
             share the work, the IDEAL split: the model axis, and the
             batch's own data-parallel axes (a train rank's inner axes,
             the serve batch's `_dp_spec` axes).  JAX's GSPMD count also
             holds replicated work, which this split does not.
  stage 2    one device's share of the coded step at `flat_pad`
             (`core.cocoef.group_cocoef_update` on a `launch.mesh.
             dry_grid` of the coding axes, on meta tensors, and the
             server update): the kernels' charges (`kernels.cost`) and
             the coded collective's calls (the phase-1 all_to_all, the
             outer sum's and phase 2's all_gathers), their wire bytes
             under `roofline.WIRE_FACTOR`, in `cost.stage2` and
             `collectives`.  `kernels` holds one device's charges (a
             serve step's B8 charges over the same ideal split).
  roofline   `roofline.roofline_terms` of one device: stage 1's ideal dot
             flops and the kernels' operations, each at its dtype's
             peak; stage 1's eager bytes over the same split plus stage
             2's eager and kernel bytes (an unfused count: the memory
             term is an upper bound); the wire bytes; the card's rates
             (`roofline.CARD`).

Not recorded, for want of a sharded step to read them from: the model
axis's own collectives (GSPMD's all-gathers and reduce-scatters of the
tensor-parallel matmuls and of FSDP), and XLA's `temp_bytes` and
`peak_estimate_bytes`.  They come with the sharded execution (ROADMAP).

Results are JSON under results/dryrun_torch/, read back unless --force.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
      [--force] [--table]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import REGISTRY, STANDARD_SHAPES, get_arch
from repro_torch.configs.common import ArchSpec, ShapeCfg
from repro_torch.core.cocoef import (group_buffers, group_cocoef_update,
                                     padded_size)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import MeshLayout, dry_grid, \
    make_production_mesh
from repro_torch.launch.op_cost import OpCounter
# the serve's argument specs are launch.serve's (its `input_specs`), read
# from here too
from repro_torch.launch.serve import (_ITEMSIZE, Arg, arg, dp_spec,  # noqa
                                      part_bytes, serve_specs)
from repro_torch.launch.train import TrainRun
from repro_torch.nn import transformer as T
from repro_torch.nn.models import Model
from repro_torch.optim.optimizers import (apply_update, init_opt_state,
                                          lr_schedule)
from repro_torch.sharding import rules

__all__ = ["Arg", "train_specs", "serve_specs", "part_bytes", "dp_spec",
           "run_cell", "cell_path", "main"]

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
META = torch.device("meta")


# --------------------------------------------------------------------------
# argument specs
# --------------------------------------------------------------------------

def train_specs(spec: ArchSpec, shape: ShapeCfg, mesh: MeshLayout,
                run: TrainRun = TrainRun(), smoke: bool = False
                ) -> Dict[str, Any]:
    """JAX's `TrainSetup` on `mesh`, shapes only: the coding ranks
    (n_code over the arch's coding axes on the mesh, `effective_mode`
    "dense" when n_code <= 1), b_loc, flat_pad (`padded_size` of one
    device's local flat over the chunk ranks, the wire's pad multiple and
    the buckets), and `parts`: params, e and opt (mesh_shape + (flat_pad,)
    over every axis), batch (the coding axes lead, the other batch axes
    inside; the embeddings input for the embeddings archs), step, key.
    smoke: the arch's smoke config in place of its full width."""
    cfg = spec.smoke if smoke else spec.config
    if run.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=run.param_dtype)
    sizes = mesh.axis_sizes
    coding_axes = tuple(a for a in spec.coding.coding_axes
                        if a in mesh.axis_names)
    n_code = math.prod(sizes[a] for a in coding_axes) if coding_axes else 1
    mode = run.mode if n_code > 1 else "dense"
    run = dataclasses.replace(run, mode=mode)
    plan = run.resolve_plan(spec.coding, n_code)
    ccfg = run.coding_config(spec.coding, n_code)
    per_subset = max(1, shape.global_batch // n_code)
    b_loc = per_subset * plan.d
    seq = shape.seq_len

    pshapes = T.param_shapes(cfg)
    pspecs = rules.param_specs(pshapes, cfg, mesh, fsdp=spec.coding.fsdp)
    nd = sizes[coding_axes[-1]] if coding_axes else 1
    loc = rules.local_flat_size(pshapes, pspecs, mesh)
    flat_pad = padded_size(loc, nd, ccfg.pad_multiple, plan.num_buckets)
    state_shape = mesh.shape + (flat_pad,)
    state_spec = mesh.axis_names + (None,)
    n_opt = len(init_opt_state(run.optimizer, 1, META))

    inner = rules.entry([a for a in ("pod", "data")
                    if a in mesh.axis_names and a not in coding_axes])
    lead = rules.entry(coding_axes)
    batch = {}
    if cfg.input_mode == "tokens":
        batch["inputs"] = arg((n_code, b_loc, seq + 1), "int32",
                               (lead, inner, None), mesh)
    else:
        batch["inputs"] = arg((n_code, b_loc, seq, cfg.d_model),
                               "bfloat16", (lead, inner, None, None), mesh)
        batch["targets"] = arg((n_code, b_loc, seq), "int32",
                                (lead, inner, None), mesh)
    batch["weights"] = arg((n_code, b_loc), "float32", (lead, inner), mesh)
    if run.elastic:
        batch["subset_ids"] = arg((n_code, b_loc), "int32", (lead, inner),
                                   mesh)
    parts = {
        "params": {n: arg(s, cfg.param_dtype, pspecs[n], mesh)
                   for n, s in pshapes.items()},
        "e": arg(state_shape, run.ef_dtype, state_spec, mesh),
        "opt": tuple(arg(state_shape, "float32", state_spec, mesh)
                     for _ in range(n_opt)),
        "batch": batch,
        "step": arg((), "int32", (), mesh),
        "key": arg((2,), "uint32", (), mesh),
    }
    if run.elastic:
        m = max(n_code, 1)
        parts["coding_state"] = {
            "rates_estimate": arg((m,), "float32", (), mesh),
            "W": arg((m, n_code), "float32", (), mesh),
            "epoch": arg((), "int32", (), mesh)}
    return {"cfg": cfg, "run": run, "ccfg": ccfg, "n_code": n_code,
            "coding_shape": tuple(sizes[a] for a in coding_axes),
            "data_size": sizes.get("data", 1), "b_loc": b_loc, "seq": seq,
            "flat_pad": flat_pad, "effective_mode": mode, "parts": parts}


# --------------------------------------------------------------------------
# counts on the meta device
# --------------------------------------------------------------------------

def stage1_count(cfg, b_loc: int, seq: int, loop_shortcut: bool = True
                 ) -> OpCounter:
    """One coding rank's stage 1 on the meta device: the loss of a
    (b_loc, seq) batch and its backward pass (the port's remat), the
    full-width model built there."""
    model = Model(cfg, device=META)
    w = torch.ones(b_loc, device=META)
    if cfg.input_mode == "tokens":
        args = (torch.zeros((b_loc, seq + 1), dtype=torch.long,
                            device=META), w)
    else:
        args = (torch.zeros((b_loc, seq, cfg.d_model), dtype=torch.bfloat16,
                            device=META), w,
                torch.zeros((b_loc, seq), dtype=torch.long, device=META))
    with OpCounter(loop_shortcut) as c:
        loss, _ = model.loss(*args)
        loss.backward()
    return c


def serve_count(cfg, kind: str, B: int, S: int, cache_len: int,
                loop_shortcut: bool = True) -> OpCounter:
    """One prefill of (B, S), or one decode step of B tokens into caches
    of cache_len, on the meta device."""
    model = Model(cfg, device=META, with_grad=False)
    tok = cfg.input_mode == "tokens"
    L = S if kind == "prefill" else 1
    x = (torch.zeros((B, L), dtype=torch.long, device=META) if tok else
         torch.zeros((B, L, cfg.d_model), dtype=torch.bfloat16, device=META))
    with torch.inference_mode():
        caches = (None if kind == "prefill" else
                  model.init_caches(B, cache_len))
        with OpCounter(loop_shortcut) as c:
            if kind == "prefill":
                model.prefill(x)
            else:
                model.decode_step(caches, x, cache_len - 1)
    return c


def stage2_count(tr: Dict[str, Any]) -> Tuple[OpCounter, list]:
    """One device's stage 2 of a `train_specs` cell on the meta device:
    `group_cocoef_update` on its (flat_pad,) gradient slice over a dry
    grid of the coding axes, then the server update.  Returns the
    counter and the collective's recorded calls.  Without coding ranks
    (n_code 1) JAX's step psums the whole local flat over the data axis
    (dense mode's fallback axis): one all-reduce, recorded as such."""
    cfg, run, ccfg = tr["cfg"], tr["run"], tr["ccfg"]
    n = tr["flat_pad"]
    g = torch.empty(n, dtype=getattr(torch, cfg.param_dtype), device=META)
    theta = torch.empty_like(g)
    e = (torch.empty(n, dtype=getattr(torch, run.ef_dtype), device=META)
         if ccfg.mode == "cocoef" else None)
    ghat = torch.empty(n, dtype=torch.float32, device=META)
    opt = init_opt_state(run.optimizer, n, META)
    gamma = lr_schedule(run.schedule, run.base_lr, run.warmup,
                        run.schedule_total)(0)
    calls: list = []
    with OpCounter() as c:
        if tr["n_code"] > 1:
            grid = dry_grid(tr["coding_shape"])
            calls = grid.chunk_group.calls
            mask = torch.ones(tr["n_code"], device=META)
            out = group_cocoef_update(
                g, e, mask, gamma.to(META), ccfg, grid,
                group_buffers(ccfg, grid.nd, n, META), out=ghat)
        else:
            out = torch.mul(g.float(), gamma.to(META), out=ghat)
            calls.append({"op": "all-reduce", "phase": "dense",
                          "result_bytes": 4 * n,
                          "group": tr["data_size"]})
        apply_update(run.optimizer, theta, out, opt, 0, gamma)
    return c, calls


def _wire(calls) -> Dict[str, Any]:
    by_op: Dict[str, float] = {}
    by_phase: Dict[str, float] = {}
    total = 0.0
    for c in calls:
        w = roofline.wire_bytes(c["op"], c["result_bytes"], c["group"])
        by_op[c["op"]] = by_op.get(c["op"], 0.0) + w
        key = ("phase1" if c["op"] == "all-to-all" else
               "phase2" if c["phase"] == "chunk" else c["phase"])
        by_phase[key] = by_phase.get(key, 0.0) + w
        total += w
    return {"wire_bytes_per_device": total, "by_op": by_op,
            "by_phase": by_phase, "calls": list(calls)}


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             mode: str = "cocoef", extra_run: Optional[dict] = None
             ) -> Dict[str, Any]:
    """The record of one cell (JAX's keys where the quantity is the same:
    status, reason, n_code, b_loc, flat_pad, effective_mode, cache_len,
    memory.argument_bytes, roofline); a cell that fails records status
    "fail" with its error."""
    spec = get_arch(arch_id)
    mesh_name = "multi" if multi_pod else "single"
    rec: Dict[str, Any] = {"arch": arch_id, "shape": shape_name,
                           "mesh": mesh_name, "mode": mode,
                           "status": "unknown"}
    if shape_name in spec.skip_shapes:
        rec.update(status="skipped", reason=spec.skip_shapes[shape_name])
        return rec
    shape = spec.shapes[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        sizes = mesh.axis_sizes
        if shape.is_train:
            tr = train_specs(spec, shape, mesh,
                             TrainRun(mode=mode, **(extra_run or {})))
            parts = tr["parts"]
            rec.update(n_code=tr["n_code"], b_loc=tr["b_loc"],
                       flat_pad=tr["flat_pad"],
                       effective_mode=tr["effective_mode"])
            split = mesh.size // tr["n_code"]
            c1 = stage1_count(tr["cfg"], tr["b_loc"], tr["seq"])
            c2, calls = stage2_count(tr)
        else:
            kind = "decode" if shape.kind == "decode" else "prefill"
            sv = serve_specs(spec, shape, mesh, kind)
            parts = sv["parts"]
            rec["cache_len"] = sv["cache_len"]
            rec["batch_axes"] = list(sv["batch_axes"])
            split = sizes.get("model", 1) * math.prod(
                sizes[a] for a in sv["batch_axes"])
            c1 = serve_count(sv["cfg"], kind, shape.global_batch,
                             shape.seq_len, sv["cache_len"])
            c2, calls = None, []
        rec["spec_s"] = time.time() - t0
        by_part = part_bytes(parts)
        rec["memory"] = {"argument_bytes": sum(by_part.values()),
                         "by_part": by_part}
        flops = {dt: f / split for dt, f in c1.dot_flops.items()}
        s1 = c1.record()
        s2 = c2.record() if c2 is not None else None
        # stage 1's counts are the whole rank's (step's): split ideally;
        # stage 2's are one device's already
        kernels = {k: {**v, "launches": v["launches"] / split,
                       "bytes": v["bytes"] / split, "ops": v["ops"] / split}
                   for k, v in s1["kernels"].items()}
        kernels.update(s2["kernels"] if s2 is not None else {})
        eager = s1["bytes_eager"] / split + (
            s2["bytes_eager"] if s2 is not None else 0.0)
        kbytes = sum(v["bytes"] for v in kernels.values())
        rec["cost"] = {
            "split": split,
            "flops_ideal_per_device": sum(flops.values()),
            "dot_flops_per_device_by_dtype": flops,
            "bytes_eager_per_device": eager,
            "kernel_bytes_per_device": kbytes,
            "stage1": s1, "stage2": s2,
        }
        rec["kernels"] = kernels
        rec["collectives"] = _wire(calls)
        ops = dict(flops)            # the kernels' operations too (B8's)
        for v in kernels.values():
            ops[v["ops_dtype"]] = ops.get(v["ops_dtype"], 0.0) + v["ops"]
        rec["roofline"] = roofline.roofline_terms(
            ops, eager + kbytes,
            rec["collectives"]["wire_bytes_per_device"],
            peak_flops=roofline.PEAK_FLOPS)
        rec["card"] = roofline.CARD
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record, don't crash the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.time() - t0
    return rec


def cell_path(arch_id: str, shape_name: str, mesh_name: str,
              mode: str = "cocoef", tag: str = "") -> Path:
    sfx = f"_{tag}" if tag else ""
    return RESULTS / f"{arch_id}__{shape_name}__{mesh_name}__{mode}{sfx}.json"


def summary(rec: Dict[str, Any]) -> str:
    """One line of a cell's record."""
    s = rec["status"]
    head = f"[{s}] {rec['arch']} {rec['shape']} {rec['mesh']}"
    if s == "ok":
        r = rec["roofline"]
        tflop = rec["cost"]["flops_ideal_per_device"] / 1e12
        wire_mb = rec["collectives"]["wire_bytes_per_device"] / 1e6
        return (f"{head} ({rec['total_s']:.1f}s) dominant={r['dominant']}"
                f" comp={r['compute_s'] * 1e3:.2f}ms"
                f" mem={r['memory_s'] * 1e3:.2f}ms"
                f" coll={r['collective_s'] * 1e3:.2f}ms"
                f" argGB={rec['memory']['argument_bytes'] / 1e9:.2f}"
                f" TFLOP/dev={tflop:.3f} wireMB={wire_mb:.1f}")
    if s == "fail":
        return f"{head} {rec['error'][:160]}"
    return f"{head}: {rec.get('reason', '')[:80]}"


def table(recs) -> str:
    """A markdown table of cell records, one row a cell with the single-
    and multi-pod meshes' values side by side ("s / m"); skipped cells
    listed under it."""
    rows, skips, cells = [], [], {}
    for r in recs:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def both(f, c):
        return " / ".join(f(c[m]) if m in c and c[m]["status"] == "ok"
                          else (c[m]["status"] if m in c else "—")
                          for m in ("single", "multi"))
    for (arch, shape), c in cells.items():
        if all(r["status"] == "skipped" for r in c.values()):
            skips.append(f"{arch} {shape}")
            continue
        rows.append("| " + " | ".join([
            f"{arch} {shape}",
            both(lambda r: str(r.get("n_code", r.get("cache_len"))), c),
            both(lambda r: str(r.get("b_loc", "—")), c),
            both(lambda r: str(r.get("flat_pad", "—")), c),
            both(lambda r: f"{r['memory']['argument_bytes'] / 1e9:.2f}", c),
            both(lambda r: "%.3f" % (
                r["cost"]["flops_ideal_per_device"] / 1e12), c),
            both(lambda r: "%.1f" % (
                r["collectives"]["wire_bytes_per_device"] / 1e6), c),
            both(lambda r: r["roofline"]["dominant"], c)]) + " |")
    head = ("| cell | n_code (serve: cache_len) | b_loc | flat_pad | "
            "argument GB a device | ideal dot TFLOP a device | coded wire "
            "MB a device | dominant |\n|---|---|---|---|---|---|---|---|")
    return "\n".join([head] + rows) + (
        f"\n\nSkipped (JAX's reasons): {', '.join(skips)}." if skips else "")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--mode", default="cocoef",
                    choices=("cocoef", "coco", "dense"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--table", action="store_true",
                    help="print the cells' records as a markdown table")
    ap.add_argument("--run-json", default=None,
                    help='JSON overrides for TrainRun, e.g. '
                         '\'{"ef_dtype": "bfloat16"}\'')
    args = ap.parse_args(argv)
    extra_run = json.loads(args.run_json) if args.run_json else None

    RESULTS.mkdir(parents=True, exist_ok=True)
    archs = list(REGISTRY) if (args.all or not args.arch) else [args.arch]
    shapes = list(STANDARD_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t0 = time.time()
    n_ok = n_fail = n_skip = 0
    recs = []
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                mname = "multi" if mp else "single"
                path = cell_path(arch, shp, mname, args.mode, args.tag)
                if path.exists() and not args.force:
                    rec = json.loads(path.read_text())
                    recs.append(rec)
                    print(f"[cached] {arch} {shp} {mname}: {rec['status']}")
                    continue
                rec = run_cell(arch, shp, mp, args.mode, extra_run)
                recs.append(rec)
                path.write_text(json.dumps(rec, indent=1))
                s = rec["status"]
                n_ok += s == "ok"
                n_fail += s == "fail"
                n_skip += s == "skipped"
                print(summary(rec), flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skipped={n_skip} in "
          f"{time.time() - t0:.1f} s")
    if args.table:
        print(table(recs))


if __name__ == "__main__":
    main()
