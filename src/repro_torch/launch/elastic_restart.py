"""Elastic scaling on the coded step (port of `examples/elastic_restart.py`):
train olmoe-1b-7b through `TrainSetup.train_step` on 4 coding ranks,
checkpoint, then resume with 2 coding ranks.

JAX's example runs its smoke config on a (pod, data, model) = (2, 2, 2)
mesh, then on (1, 2, 2); the port puts the coding ranks of the (pod, data)
grid on one device: 4, then 2.  Across the resize

  * theta restores from the checkpoint into the new setup (its leaves do
    not depend on the number of ranks);
  * the error vectors and the optimizer state map through
    `checkpoint.elastic_rescale_ef`: coding ranks in both grids (ranks 0
    and 1, pod 0 of the row-major (pod, data) grid) keep their error,
    the rest drop, and each row is truncated or zero-padded to the new
    flat size (Theorem 1 is invariant to e_i^0 = 0);
  * the coding plane resizes: `RateEstimator.resize` keeps the
    survivors' rate statistics, and the fresh setup's `CodingPlan` plans
    the new fleet's allocation.

The sign wire at g 32 runs `ef_sign_fused` once a rank a step (4 in phase
1, 2 in phase 2) and `sign_decode_reduce` once a step.

  PYTHONPATH=src python -m repro_torch.launch.elastic_restart [--device cpu]
      [--layers L] [--steps S] [--ckpt DIR] [--keep-ckpt]

Without --layers it runs JAX's smoke config; --layers L runs the full
width at depth L.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (elastic_rescale_ef, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.configs.common import ShapeCfg
from repro_torch.core import prng
from repro_torch.core.coding_state import RateEstimator
from repro_torch.kernels.ref import wire_dtype
from repro_torch.launch.train import (TrainRun, batch_stream,
                                      build_train_setup, elastic_coding_state)
from repro_torch.launch.train_e2e import elastic_tick
from repro_torch.optim.optimizers import OptimizerConfig

ARCH = "olmoe-1b-7b"
SHAPE = ShapeCfg("train", seq_len=64, global_batch=16)
CODING = dict(group_size=32, block_size=64, k_per_block=8, straggler_p=0.25)
GRID_1, GRID_2 = (2, 2), (1, 2)   # (pod, data) of JAX's two meshes
STEPS_1, STEPS_2 = 10, 10


def build(n_code: int, smoke: bool = True, layers: Optional[int] = None,
          device="cuda", optimizer: OptimizerConfig = OptimizerConfig()):
    """The example's setup on n_code coding ranks: olmoe-1b-7b with JAX's
    coding overrides, its smoke config or (smoke=False) full width, at
    `layers` layers when given."""
    spec = get_arch(ARCH)
    spec = dataclasses.replace(spec, coding=dataclasses.replace(
        spec.coding, **CODING))
    if layers is not None:
        field = "smoke" if smoke else "config"
        spec = dataclasses.replace(spec, **{field: dataclasses.replace(
            getattr(spec, field), num_layers=layers)})
    run = TrainRun(base_lr=5e-3, mode="cocoef", compressor="sign",
                   straggler="hetero", elastic=True, optimizer=optimizer)
    return build_train_setup(spec, SHAPE, run, smoke=smoke, n_code=n_code,
                             device=device)


def _sync(setup) -> None:
    if setup.device.type == "cuda":
        torch.cuda.synchronize(setup.device)


def train(setup, e: torch.Tensor, estimator: RateEstimator, start: int,
          steps: int) -> List[dict]:
    """`steps` steps from `start` with the elastic plane ticking after each
    (JAX's `train`).  Returns one record a step: step, loss, step_s (host
    clock, ending in a synchronise), kernel_spans_ms (each rank's local
    step, then the decode; [] on the CPU), mask, rates (the estimator's,
    after this step's mask), epoch, reallocated."""
    seen = estimator.steps_seen.any()
    state, _ = elastic_coding_state(setup, estimator.rates if seen
                                    else None)
    batches = batch_stream(setup, start_step=start)
    recs = []
    try:
        for t in range(start, start + steps):
            batch = next(batches)
            spans = []
            t0 = time.perf_counter()
            m = setup.train_step(setup.model, e, batch, t,
                                 kernel_spans=spans, coding_state=state)
            loss = m["loss"].item()
            _sync(setup)
            step_s = time.perf_counter() - t0
            state, info = elastic_tick(setup, estimator, m["mask"])
            tag = (f" (replan -> epoch {info['epoch']})"
                   if info["reallocated"] else "")
            print(f"  step {t:3d} loss={loss:.4f}{tag}")
            recs.append({"step": t, "loss": loss, "step_s": step_s,
                         "kernel_spans_ms": [a.elapsed_time(b)
                                             for a, b in spans],
                         "mask": m["mask"].tolist(),
                         "rates": estimator.rates.tolist(),
                         "epoch": info["epoch"],
                         "reallocated": info["reallocated"]})
    finally:
        batches.close()
    return recs


def survivors(grid_old, grid_new) -> List[tuple]:
    """(old rank, new rank) of every coding rank in both grids: the
    row-major (pod, data) indices the two grids share."""
    common = [min(a, b) for a, b in zip(grid_old, grid_new)]
    return [(int(np.ravel_multi_index(ix, grid_old)),
             int(np.ravel_multi_index(ix, grid_new)))
            for ix in np.ndindex(*common)]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    w = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(w), b.view(w))


@torch.no_grad()
def resume(setup, ckpt, step: int, flat_old: int, n_opt: int = 0,
           digest: Optional[Callable] = None) -> tuple:
    """Restore the checkpoint of `step` (written on GRID_1's ranks, flat
    size flat_old, n_opt optimizer vectors) into `setup` (GRID_2's
    ranks): theta into the model, e and the optimizer state through
    `elastic_rescale_ef`.  Returns (step, e, info) with info {"restore_s",
    "rescale_s", "e_digest": digest(the restored rows of the ranks in both
    grids), or None without a digest, "e_rows_equal": each such rescaled
    row equals its restored row cut to the shorter flat size, bit for
    bit, "e_tail_zero": every other entry of the rescaled e is zero,
    "opt_equal": the same for the optimizer vectors}."""
    n1, n2 = int(np.prod(GRID_1)), int(np.prod(GRID_2))
    flat_new, dev = setup.flat_pad, setup.device
    e_old = torch.empty((n1, 1, flat_old),
                        dtype=wire_dtype(setup.run.ef_dtype), device=dev)
    opt_old = {str(i): torch.empty(flat_old, dtype=torch.float32,
                                   device=dev) for i in range(n_opt)}
    templates = {"params": setup.model.params(), "e": e_old}
    if opt_old:
        templates["opt"] = opt_old
    info = {}
    t0 = time.perf_counter()
    step, _ = restore_checkpoint(ckpt, templates, step=step)
    _sync(setup)
    info["restore_s"] = time.perf_counter() - t0
    # the ranks in both grids keep their slices, the rest start at 0
    t0 = time.perf_counter()
    e_old = e_old.view(*GRID_1, flat_old)
    e = elastic_rescale_ef(e_old, GRID_1, GRID_2,
                           flat_new).view(n2, flat_new)
    for i, o in enumerate(setup.opt_state):
        o.copy_(elastic_rescale_ef(opt_old[str(i)], (), (), flat_new))
    _sync(setup)
    info["rescale_s"] = time.perf_counter() - t0
    e_old = e_old.view(n1, flat_old)
    m = min(flat_old, flat_new)
    pairs = survivors(GRID_1, GRID_2)
    kept = {b for _, b in pairs}
    info["e_digest"] = (digest([e_old[a] for a, _ in pairs]) if digest
                        else None)
    info["e_rows_equal"] = all(_same_bits(e_old[a, :m], e[b, :m])
                               for a, b in pairs)
    info["e_tail_zero"] = all(
        bool((e[b, m:] == 0).all()) if b in kept else bool((e[b] == 0).all())
        for b in range(n2))
    info["opt_equal"] = all(
        _same_bits(opt_old[str(i)][:m], o[:m]) and bool((o[m:] == 0).all())
        for i, o in enumerate(setup.opt_state))
    return step, e, info


def run(smoke: bool = True, layers: Optional[int] = None,
        steps_1: int = STEPS_1, steps_2: int = STEPS_2,
        ckpt: Optional[str] = None, keep_ckpt: bool = False, device="cuda",
        optimizer: OptimizerConfig = OptimizerConfig(),
        digest: Optional[Callable] = None) -> dict:
    """Phase 1 on GRID_1's ranks, the checkpoint, phase 2 on GRID_2's.
    ckpt: the checkpoint directory (default: a new temporary one), removed
    at the end unless keep_ckpt.  digest(rows), when given, is taken of
    phase 1's e rows of the ranks in both grids before phase 1 is freed,
    and of the same rows restored from the checkpoint (`resume`), so a
    caller can compare them without a copy.  Returns {"phase1",
    "phase2": {"n_code", "flat_pad", "steps": `train`'s records, ...},
    "ckpt": {"path", "bytes", "save_s"}, "resume": `resume`'s info,
    "e_digest": (phase 1's, the restored), "rates": the estimator's
    rates just after the resize, "setup", "e" (phase 2's)}."""
    n1, n2 = int(np.prod(GRID_1)), int(np.prod(GRID_2))
    ckpt = Path(tempfile.mkdtemp(prefix="repro_torch_elastic_")
                if ckpt is None else ckpt)
    out = {}
    try:
        # ---- phase 1: 4 coding ranks --------------------------------------
        setup = build(n1, smoke, layers, device, optimizer)
        print(f"[phase 1] grid {GRID_1}: n_code={setup.n_code} "
              f"local flat={setup.flat_pad}")
        t0 = time.perf_counter()
        e = setup.init_state(prng.PRNGKey(0))
        _sync(setup)
        init_s = time.perf_counter() - t0
        est = RateEstimator(setup.n_code)
        recs = train(setup, e, est, 0, steps_1)
        out["phase1"] = {"n_code": setup.n_code, "flat_pad": setup.flat_pad,
                         "init_s": init_s, "steps": recs}
        digest_1 = (digest([e[a] for a, _ in survivors(GRID_1, GRID_2)])
                    if digest else None)
        state = {"params": setup.model.params(),
                 "e": e.view(setup.n_code, 1, -1)}
        if setup.opt_state:
            state["opt"] = {str(i): o for i, o in enumerate(setup.opt_state)}
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt, steps_1, state)
        out["ckpt"] = {"path": str(path), "bytes": path.stat().st_size,
                       "save_s": time.perf_counter() - t0}
        print(f"[phase 1] checkpointed at step {steps_1}, "
              f"loss={recs[-1]['loss'] if recs else float('nan'):.4f}")
        flat_1, n_opt = setup.flat_pad, len(setup.opt_state)
        del state, e, setup
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

        # ---- phase 2: 2 coding ranks --------------------------------------
        setup = build(n2, smoke, layers, device, optimizer)
        print(f"[phase 2] grid {GRID_2}: n_code={setup.n_code} "
              f"local flat={setup.flat_pad}")
        start, e, info = resume(setup, ckpt, steps_1, flat_1, n_opt,
                                digest=digest)
        out["resume"] = info
        out["e_digest"] = (digest_1, info["e_digest"])
        est.resize(setup.n_code)          # survivors keep their statistics
        out["rates"] = est.rates
        recs = train(setup, e, est, start, steps_2)
        out["phase2"] = {"n_code": setup.n_code, "flat_pad": setup.flat_pad,
                         "steps": recs}
        if recs:
            print(f"[phase 2] step {start + steps_2} "
                  f"loss={recs[-1]['loss']:.4f}  (training continued "
                  f"through the resize; phase-1 final loss was "
                  f"{out['phase1']['steps'][-1]['loss']:.4f})")
        out["setup"], out["e"] = setup, e
    finally:
        if not keep_ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.elastic_restart",
        description="COCO-EF on 4 coding ranks, checkpoint, resume on 2 "
                    "(the port of examples/elastic_restart.py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="full width at this depth (default: JAX's smoke "
                         "config)")
    ap.add_argument("--steps", type=int, default=STEPS_1,
                    help="steps of each phase")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--keep-ckpt", action="store_true",
                    help="leave the checkpoint directory in place")
    a = ap.parse_args(argv)
    run(smoke=a.layers is None, layers=a.layers, steps_1=a.steps,
        steps_2=a.steps, ckpt=a.ckpt, keep_ckpt=a.keep_ckpt,
        device=a.device)


if __name__ == "__main__":
    main()
