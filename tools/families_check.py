#!/usr/bin/env python3
"""Quick run of chip_smoke.py's phase 10 (the families at full width) on
one NVIDIA GPU, without its other phases: builds the kernels, holds the
chosen archs' smoke steps on the card against the CPU (`step_parity`,
stage 2 bit for bit) and their smoke loss and backward without a host
sync (`loss_no_sync`), runs the chosen cells of `FAMILY_CELLS` at full
width one at a time (exact launch counts, finite losses, peaks), then
their kernels at their shapes against the plain versions, timed.

    PYTHONPATH=src python tools/families_check.py [--cells KEY,...]
        [--layers KEY=N,...] [--steps N] [--no-kernels] [--profile]
        [--blocks ARCH,...]

--cells    keys of chip_smoke.FAMILY_CELLS (default: deepseek, zamba2,
           xlstm)
--layers   cut a cell's depth (e.g. xlstm=8: one group); widths stay full
--steps    steps of every cell (default: the cell's own)
--profile  after each cell, one more step of a "setup" cell under
           torch.profiler: the ops with the most device time, and the
           host time inside the sLSTM scan (`SLSTMScan` forward and
           backward) against the step's
--blocks   first, each block kind of these archs alone at full width
           (a rank's batch, forward and backward, timed and profiled;
           for xlstm-1.3b first the pieces of one sLSTM time step); with
           --cells "" nothing else
Exits non-zero on any failure (chip_smoke's checks).  The numbers are
chip_smoke.py's own; this is the short loop for iterating on phase 10.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def profile_step(torch, key, cell) -> None:
    """One step of cell `key` (a "setup" cell) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import REGISTRY, ShapeCfg
    from repro_torch.launch.train import TrainRun, build_train_setup
    arch, how, layers, _, comp = cell
    spec = REGISTRY[arch]
    if layers:
        spec = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, num_layers=layers))
    setup = build_train_setup(spec, ShapeCfg("train", cs.SEQ_LEN,
                                             cs.GLOBAL_BATCH),
                              TrainRun(base_lr=5e-3, compressor=comp),
                              smoke=False, n_code=cs.N_CODE, device="cuda")
    e = setup.init_state()
    batch = setup.make_batch(0)
    setup.train_step(setup.model, e, batch, 0)["loss"].item()   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        setup.train_step(setup.model, e, setup.make_batch(1), 1)[
            "loss"].item()
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    ev = prof.key_averages()

    def dev_us(x):
        return (getattr(x, "self_device_time_total", None)
                or getattr(x, "self_cuda_time_total", 0))
    top = sorted(ev, key=lambda x: -dev_us(x))[:12]
    slstm_us = sum(x.cpu_time_total for x in ev
                   if x.key in ("SLSTMScan", "SLSTMScanBackward"))
    print(f"profile ({key}): " + json.dumps({
        "step_s_profiled": step_s,
        "device_s": sum(dev_us(x) for x in ev) / 1e6,
        "device_ops": sum(x.count for x in ev if dev_us(x) > 0),
        "slstm_host_s": slstm_us / 1e6,
        "top": [(x.key[:60], x.count, dev_us(x) / 1e3) for x in top]}),
        flush=True)
    del setup, e, batch, prof
    cs.settle(torch, f"the {key} profile")


def block_times(torch, arch: str, reps: int = 2) -> None:
    """Each block kind of `arch` alone at full width on the card: seeded
    weights, x (2, SEQ_LEN, d) bf16 (a rank's batch), forward and
    backward `reps` times after a warm-up, host seconds (synchronised)
    each, then one run under torch.profiler: its device seconds, device
    ops and the ops with the most device and host time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import REGISTRY
    from repro_torch.nn import layers as L, ssm as SSM, xlstm as XL
    cfg = REGISTRY[arch].config
    kinds = {"deepseek-v2-lite-16b": {"mla": (
                 {"wq": (cfg.d_model, cfg.num_heads,
                         cfg.qk_nope_dim + cfg.qk_rope_dim),
                  "w_dkv": (cfg.d_model, cfg.kv_lora_rank
                            + cfg.qk_rope_dim),
                  "w_uk": (cfg.kv_lora_rank, cfg.num_heads,
                           cfg.qk_nope_dim),
                  "w_uv": (cfg.kv_lora_rank, cfg.num_heads,
                           cfg.v_head_dim),
                  "wo": (cfg.num_heads, cfg.v_head_dim, cfg.d_model),
                  "kv_norm": (cfg.kv_lora_rank,)}, L.mla_train)},
             "zamba2-2.7b": {"mamba2": (SSM.leaf_shapes(cfg),
                                        SSM.apply_mamba2)},
             "xlstm-1.3b": {"mlstm": (XL.mlstm_shapes(cfg), XL.apply_mlstm),
                            "slstm": (XL.slstm_shapes(cfg),
                                      XL.apply_slstm)}}[arch]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, (shapes, fn) in kinds.items():
        p = {k: (torch.randn(v, device="cuda", generator=gen)
                 * (v[0] ** -0.5 if len(v) > 1 else 0.1)).requires_grad_()
             for k, v in shapes.items()}
        x = torch.randn((2, cs.SEQ_LEN, cfg.d_model), device="cuda",
                        generator=gen).bfloat16().requires_grad_()

        def run():
            fn(p, x, cfg).float().square().mean().backward()
        run()
        torch.cuda.synchronize()
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ev = prof.key_averages()

        def dev_us(e):
            return (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0))
        top_dev = sorted(ev, key=lambda e: -dev_us(e))[:10]
        top_cpu = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:10]
        print(f"block ({arch} {kind}, fwd + bwd): " + json.dumps({
            "s": secs, "device_s": sum(dev_us(e) for e in ev) / 1e6,
            "device_ops": sum(e.count for e in ev if dev_us(e) > 0),
            "top_device_ms": [(e.key[:50], e.count, dev_us(e) / 1e3)
                              for e in top_dev],
            "top_host_ms": [(e.key[:50], e.count,
                             e.self_cpu_time_total / 1e3)
                            for e in top_cpu]}), flush=True)
        del p, x, prof
        cs.settle(torch, f"the {kind} block")


def slstm_parts(torch, reps: int = 200) -> None:
    """The pieces of one sLSTM time step at xlstm-1.3b's width (a rank's
    B 2, d 2048, f32), each run `reps` times back to back: host
    microseconds a call (synchronised at the end; the host issues them
    as fast as it can) and device microseconds a call (CUDA events).
    The recurrent product h @ W_h and dpre @ W_h^T as the port writes
    them, with W_h at the flat buffer's alignment, and as per-row GEMVs
    (`torch.mv`); the cell, its written-out vjp and autograd's; then the
    whole scan (SEQ_LEN steps, forward and backward) with W_h as a view
    at the flat buffer's alignment and in its own allocation, twice each
    in turn."""
    from repro_torch.configs import REGISTRY
    from repro_torch.nn import xlstm as XL
    d = REGISTRY["xlstm-1.3b"].config.d_model
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale
    wh, h, dp = rnd(d, 4 * d, scale=d ** -0.5), rnd(2, d), rnd(2, 4 * d)
    wh_t = wh.T.contiguous()
    # W_h where the flat parameter buffer puts it: 64 bytes past a
    # 256-byte boundary
    flat = torch.empty(wh.numel() + 64, device="cuda")
    wh_view = flat[16:16 + wh.numel()].view_as(wh).copy_(wh)
    pre, c, m = rnd(2, 4 * d), rnd(2, d), rnd(2, d)
    n = rnd(2, d).abs() + 1.0
    cts = [rnd(2, d) for _ in range(4)]

    def autograd_vjp():
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (pre, c, n, m)]
            return torch.autograd.grad(XL.slstm_cell(*ins), ins, cts)
    parts = {
        "h @ wh": lambda: h @ wh,
        "mv rows (wh^T contiguous)": lambda: [torch.mv(wh_t, r) for r in h],
        "dpre @ wh.T": lambda: dp @ wh.T,
        "h @ wh (flat view)": lambda: h @ wh_view,
        "dpre @ wh.T (flat view)": lambda: dp @ wh_view.T,
        "mv rows (wh)": lambda: [torch.mv(wh, r) for r in dp],
        "cell": lambda: XL.slstm_cell(pre, c, n, m),
        "cell vjp, written out": lambda: XL.slstm_cell_vjp(pre, c, n, m,
                                                          *cts),
        "cell vjp, autograd": autograd_vjp}
    # the whole scan, forward and backward, with W_h where the flat buffer
    # puts it and in an allocation of its own
    S = cs.SEQ_LEN
    px = rnd(S, 2, 4 * d).requires_grad_()
    dhs, b = rnd(S, 2, d), torch.zeros(4 * d, device="cuda")

    def scan(w):
        def run():
            hs = XL.SLSTMScan.apply(px, w, b, *XL.slstm_state(2, d, "cuda"))
            torch.autograd.grad(hs[0], (px, w), dhs)
        return run
    wh_view.requires_grad_()
    wh.requires_grad_()
    for name, w in (("scan, W_h flat view", wh_view),
                    ("scan, W_h own", wh), ("scan, W_h flat view 2", wh_view),
                    ("scan, W_h own 2", wh)):
        parts[name] = scan(w)
    out = {}
    for name, fn in parts.items():
        times = 2 if name.startswith("scan") else reps
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(times):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out[name] = {"host_us": (time.perf_counter() - t0) / times * 1e6,
                     "device_us": e0.elapsed_time(e1) / times * 1e3}
    print("slstm parts: " + json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="deepseek,zamba2,xlstm")
    ap.add_argument("--layers", default="")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--blocks", default="",
                    help="archs whose block kinds are timed alone first")
    args = ap.parse_args()
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    from repro_torch.kernels import build, ref, sign_pack as sp, \
        topk_pack as tp
    from repro_torch.kernels.common import launches
    from repro_torch.launch.device_parity import loss_no_sync, step_parity
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {cs.smi_line()}", flush=True)
    if "xlstm-1.3b" in args.blocks:
        slstm_parts(torch)
    for arch in filter(None, args.blocks.split(",")):
        block_times(torch, arch)
    if not args.cells:
        return
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    depth = dict(kv.split("=") for kv in args.layers.split(",") if kv)
    cells = {}
    for key in args.cells.split(","):
        arch, how, layers, steps, comp = cs.FAMILY_CELLS[key]
        cells[key] = (arch, how, int(depth.get(key, layers or 0)) or None,
                      args.steps or steps, comp)
        t0 = time.perf_counter()
        try:
            out = step_parity("cuda", arch=arch, compressor=comp)
        except AssertionError as err:
            cs.fail(f"smoke-size step on the card vs the CPU ({arch}): "
                    f"{err}")
        print(f"reference ({arch}, {comp}): {json.dumps(out)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        try:
            out = loss_no_sync("cuda", arch)
        except (AssertionError, RuntimeError) as err:
            cs.fail(f"{arch}'s smoke loss and backward: {err}")
        print(f"reference ({arch}, bf16, no sync): {json.dumps(out)}",
              flush=True)
    t0 = time.perf_counter()
    counts, wires = cs.families_phase(torch, "cuda", launches, cells)
    print(f"families: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(counts)}", flush=True)
    if args.profile:
        for key, cell in cells.items():
            if cell[1] == "setup":
                profile_step(torch, key, cell)
    if not args.no_kernels:
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        cs.families_kernels(torch, ref, sp, tp, gen, "cuda", wires)
        print(f"kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "peaks": cs.PEAKS}))


if __name__ == "__main__":
    main()
