#!/usr/bin/env python3
"""Quick check of the block top-K selection kernels on one NVIDIA GPU:
builds `csrc/topk_pack.cu`, prints ptxas's report (registers, spills,
stack), holds ef_topk_fused (with and without a budget k_send < k),
topk_pack and block_topk against their plain versions at n = 2**26 on
chip_smoke.py's adversarial inputs, then times them at the train slice's
n (gemma2-2b, N = 4: 2,660,229,120) with k = 8, B = 256, f32, on random
blocks of widely varying scale and on all-zero blocks (the padding).

    PYTHONPATH=src python tools/topk_check.py [--baseline FILE.cu]
        [--yardstick] [--rounds]
    PYTHONPATH=src python tools/topk_check.py --decode [--baseline FILE.cu]
        [--sweep TILE:STAGES,...]

--baseline   another topk_pack.cu with the launch interface before the
             budget argument (ef_topk_fused_launch(..., n, B, k, bf16,
             stream), topk_pack_launch and block_topk_launch likewise),
             built beside it and timed in the same call on the same
             inputs, in the order baseline, new, new, baseline
--yardstick  torch.topk(x.view(-1, B).abs(), k) on the same x: a
             yardstick only, not the same function (its tie order differs,
             ROADMAP C1, and it writes i64 indices and f32 values)
--rounds     topk_pack at k = 1, 2, 4, 8, 16, 32 on the same x: the time
             each selection round adds
--decode     topk_decode_reduce (B4) alone instead: ptxas's report of its
             instances, chip_smoke.py's small-n tile shapes against the
             plain version at every B, then B4 on the driver's wire (B 64,
             k 8, budgets 8, 8, 3, 1, a straggler, n = 2,660,228,352) and
             on the slice's (B 256, k 8, n = 2,660,229,120), timed beside
             the scatter_add_ yardstick; --baseline is then a topk_pack.cu
             with the same decode interface (e.g. the parent's), whose
             output must equal the new kernel's bit for bit, timed in the
             order baseline, new, new, baseline; beside them a stream
             floor: PyTorch's zero_ of the output plus an amax over each
             payload tensor, one pass each over the same bytes
--sweep      with --decode: variants of the kernel built with
             -DTOPK_DECODE_TILE=TILE -DTOPK_DECODE_STAGES=STAGES (all
             nvcc at once) and timed on the same two instances

Exits 1 if a kernel differs from its plain version.  Much shorter than
chip_smoke.py: the tool for iterating on the selection and, with
--decode, on topk_decode_reduce.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

CHECK_N = 1 << 26
REPS = 10


def ptxas_lines(report: str) -> list:
    return [ln.strip() for ln in report.splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln
            or "stack" in ln or "warning" in ln]


def decode_lines(report: str) -> list:
    """ptxas's lines for the topk_decode_reduce instances."""
    out, on = [], False
    for ln in report.splitlines():
        if "Compiling entry" in ln:
            on = "topk_decode_reduce" in ln
        if on and ("Compiling entry" in ln or "Used" in ln or "spill" in ln
                   or "stack" in ln):
            out.append(ln.strip())
    return out


def decode_lib(lib):
    from repro_torch.kernels.common import I, LL, VP
    lib.topk_decode_reduce_launch.argtypes = [VP] * 5 + [I, LL, I, I, I, VP]
    lib.topk_decode_reduce_launch.restype = I
    return lib


def big_payload(torch, gen, dev, N: int, nb: int, k: int, B: int, budgets):
    """N senders' payloads at a large n, made chunk by chunk: positions
    (r + q*slot) mod B with r random and q random odd (distinct in a
    block), normal values (+0 past a sender's budget), scales 2^-14..2^3."""
    idx = torch.empty((N, nb, k), dtype=torch.uint16, device=dev)
    val = torch.empty((N, nb, k), device=dev)
    sc = torch.empty((N, nb), device=dev)
    slots = torch.arange(k, device=dev)
    cb = cs.CHUNK // B
    for i in range(N):
        for b0 in range(0, nb, cb):
            b1 = min(nb, b0 + cb)
            r = torch.randint(0, B, (b1 - b0, 1), device=dev, generator=gen)
            q = torch.randint(0, B // 2, (b1 - b0, 1), device=dev,
                              generator=gen) * 2 + 1
            idx[i, b0:b1].view(torch.int16).copy_((r + q * slots) % B)
        val[i].normal_(generator=gen)
        val[i, :, budgets[i]:] = 0
        sc[i].uniform_(-14, 3, generator=gen).exp2_()
    return idx, val, sc


def decode_main(args, torch, dev) -> None:
    """--decode: see the module docstring."""
    import math
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import REGISTRY
    from repro_torch.core.cocoef import padded_size
    from repro_torch.kernels import build, ref, topk_pack as tp
    from repro_torch.kernels.common import stream
    from repro_torch.launch.train_e2e import CODING_OVERRIDES
    from repro_torch.nn.transformer import num_params

    t0 = time.perf_counter()
    report = build.ptxas_report("topk_pack")
    print(f"build topk_pack: {time.perf_counter() - t0:.2f} s", flush=True)
    for ln in decode_lines(report):
        print(f"  {ln}", flush=True)
    src = build.CSRC / "topk_pack.cu"
    variants = {}
    if args.sweep:
        plans = [tuple(map(int, v.split(":"))) for v in args.sweep.split(",")]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(plans)) as pool:
            libs = pool.map(lambda p: build.library_of_file(
                src, f"topk_pack-t{p[0]}-s{p[1]}",
                (f"TOPK_DECODE_TILE={p[0]}", f"TOPK_DECODE_STAGES={p[1]}")),
                plans)
            variants = {f"tile {p[0]}, stages <= {p[1]}": decode_lib(lib)
                        for p, lib in zip(plans, libs)}
        print(f"built {len(plans)} variants in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    base = (decode_lib(build.library_of_file(args.baseline,
                                             "topk_pack-baseline"))
            if args.baseline else None)

    gen = torch.Generator(device=dev).manual_seed(0)
    n_shapes = cs.check_decode_shapes(torch, ref, tp, gen, dev)
    print(f"topk_decode_reduce bit-equal to the plain version on {n_shapes} "
          f"small-n tile shapes", flush=True)

    cfg = REGISTRY["gemma2-2b"].config
    n64 = padded_size(num_params(cfg), cs.N_CODE,
                      math.lcm(CODING_OVERRIDES["group_size"],
                               CODING_OVERRIDES["block_size"]))
    n256 = padded_size(num_params(cfg), cs.N_CODE, cs.GROUP)
    st = stream(dev)
    rows = {}
    for what, n, B, k, budgets, m in (
            ("driver budgets", n64, CODING_OVERRIDES["block_size"],
             CODING_OVERRIDES["k_per_block"], cs.DRIVER_K_BUDGETS,
             (1.0, 1.0, 1.0, 0.0)),
            ("slice", n256, cs.BLOCK, cs.K, (cs.K,) * cs.N_CODE,
             (1.0, 0.0, 1.0, 1.0))):
        nb = n // B
        idx, val, sc = big_payload(torch, gen, dev, cs.N_CODE, nb, k, B,
                                   budgets)
        mask = torch.tensor(m, device=dev)
        out = torch.empty(n, device=dev)

        def launch(lib):
            err = lib.topk_decode_reduce_launch(
                idx.data_ptr(), val.data_ptr(), sc.data_ptr(),
                mask.data_ptr(), out.data_ptr(), cs.N_CODE, n, B, k, 0, st)
            if err:
                cs.fail(f"topk_decode_reduce launch failed ({err})")

        def new():
            tp.topk_decode_reduce(idx, val, sc, mask, B, out=out)
        new()
        torch.cuda.synchronize()
        if base is not None:
            want = out.clone()
            launch(base)
            torch.cuda.synchronize()
            if not cs.same(out, want):
                cs.fail(f"topk_decode_reduce ({what}, B {B}) differs from "
                        f"the baseline's")
            del want
        times = {}
        if base is not None:
            times["baseline"] = [cs.cuda_ms(lambda: launch(base), REPS)]
        times["new"] = [cs.cuda_ms(new, REPS), cs.cuda_ms(new, REPS)]
        if base is not None:
            times["baseline"].append(cs.cuda_ms(lambda: launch(base), REPS))
        for name, lib in variants.items():
            times[name] = cs.cuda_ms(lambda: launch(lib), REPS)
        # PyTorch's own streaming passes over the same bytes: the output
        # written once (zero_), each payload tensor read once (amax)
        floor = {"write_out_ms": cs.cuda_ms(out.zero_, REPS),
                 "read_payload_ms": sum(cs.cuda_ms(lambda t=t: t.amax(), REPS)
                                        for t in (idx.view(torch.int16), val,
                                                  sc))}
        moved = 4 * n + cs.N_CODE * nb * (k * (2 + 4) + 4) + 4 * cs.N_CODE
        bound_ms = moved / cs.HBM_BYTES_PER_S * 1e3
        rows[what] = {"n": n, "block": B, "k": k, "k_send": list(budgets),
                      **times, "bound_ms": bound_ms,
                      "gb_per_s": moved / min(times["new"]) / 1e6,
                      "bound_share": bound_ms / min(times["new"]),
                      "stream_floor": floor,
                      "stream_floor_share": sum(floor.values())
                      / min(times["new"]),
                      "yardstick_scatter_add_ms": cs.scatter_add_ms(
                          torch, idx, val, sc, mask, B, out)}
        print(f"topk_decode_reduce, {what}: {json.dumps(rows[what])}",
              flush=True)
        del idx, val, sc, out
        torch.cuda.empty_cache()
    print(json.dumps({"topk_decode_reduce": rows}))


def baseline_lib(src: Path):
    """The library of another topk_pack.cu, built with the port's flags
    (old interface: no k_send)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.common import I, LL, VP
    lib = build.library_of_file(src, "topk_pack-baseline")
    lib.ef_topk_fused_launch.argtypes = [VP] * 9 + [LL, I, I, I, VP]
    lib.topk_pack_launch.argtypes = [VP] * 4 + [LL, I, I, I, VP]
    lib.block_topk_launch.argtypes = [VP] * 2 + [LL, I, I, I, VP]
    return lib


def check(torch, ref, tp, gen, dev) -> None:
    """Every output bit for bit against the plain version at CHECK_N."""
    K, B = cs.K, cs.BLOCK
    g, e = cs.topk_inputs(torch, gen, dev, CHECK_N)
    e = e[0]
    for vd in ("float32", "bfloat16"):
        for ks in (K, 2):
            for m in (1.0, 0.0):
                got = tp.ef_topk_fused(g, e, 0.37, m, K, B, vd, want_c=True,
                                       k_send=ks)
                torch.cuda.synchronize()
                want = ref.ef_topk_fused_ref(g, e, 0.37, m, K, B, vd, ks)
                cs.compare_topk(got, want, f"ef_topk_fused ({vd}, k_send="
                                f"{ks}, mask={m})")
            got = tp.topk_pack(g, K, B, vd, k_send=ks)
            torch.cuda.synchronize()
            cs.compare_topk(got, ref.topk_pack_ref(g, K, B, ks),
                            f"topk_pack ({vd}, k_send={ks})")
    for Bt in cs.TOPK_BLOCKS:
        for k in (1, K, 32):
            x = cs.pack_inputs(torch, gen, dev, CHECK_N, Bt, k)
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                if not cs.same(tp.block_topk(xd, k, Bt),
                               ref.block_topk_ref(xd, k, Bt)):
                    cs.fail(f"block_topk (B={Bt}, k={k}, {dt}) differs")
    print(f"checks at n={CHECK_N}: every output bit-equal", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--yardstick", action="store_true")
    ap.add_argument("--rounds", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--sweep")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.decode:
        dev = torch.device("cuda", 0)
        smi = cs.smi_line()
        print(f"device: {smi}", flush=True)
        decode_main(args, torch, dev)
        print(smi)
        return
    from repro_torch.configs import REGISTRY
    from repro_torch.core.cocoef import padded_size
    from repro_torch.kernels import build, ref, topk_pack as tp
    from repro_torch.kernels.common import stream
    from repro_torch.nn.transformer import num_params

    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    report = build.ptxas_report("topk_pack")
    print(f"build topk_pack: {time.perf_counter() - t0:.2f} s", flush=True)
    for ln in ptxas_lines(report):
        print(f"  {ln}", flush=True)
    base = baseline_lib(args.baseline) if args.baseline else None

    gen = torch.Generator(device=dev).manual_seed(0)
    check(torch, ref, tp, gen, dev)
    torch.cuda.empty_cache()

    K, B = cs.K, cs.BLOCK
    n = padded_size(num_params(REGISTRY["gemma2-2b"].config), cs.N_CODE,
                    cs.GROUP)
    nb = n // B
    g, e = cs.topk_inputs(torch, gen, dev, n)
    e = e[0]
    gamma = torch.tensor(5e-3, device=dev)
    mask = torch.tensor(1.0, device=dev)
    idx = torch.empty((nb, K), dtype=torch.uint16, device=dev)
    val = torch.empty((nb, K), device=dev)
    sc = torch.empty(nb, device=dev)
    y = torch.empty(n, device=dev)
    st = stream(dev)
    new = {
        "ef_topk_fused": lambda: tp.ef_topk_fused(
            g, e, gamma, mask, K, B, out=(idx, val, sc, e)),
        "ef_topk_fused k_send=2": lambda: tp.ef_topk_fused(
            g, e, gamma, mask, K, B, out=(idx, val, sc, e), k_send=2),
        "topk_pack": lambda: tp.topk_pack(g, K, B, out=(idx, val, sc)),
        "block_topk": lambda: tp.block_topk(g, K, B, out=y),
    }
    old = {}
    if base is not None:
        old = {
            "ef_topk_fused": lambda: base.ef_topk_fused_launch(
                g.data_ptr(), e.data_ptr(), gamma.data_ptr(),
                mask.data_ptr(), idx.data_ptr(), val.data_ptr(),
                sc.data_ptr(), None, e.data_ptr(), n, B, K, 0, st),
            "topk_pack": lambda: base.topk_pack_launch(
                g.data_ptr(), idx.data_ptr(), val.data_ptr(), sc.data_ptr(),
                n, B, K, 0, st),
            "block_topk": lambda: base.block_topk_launch(
                g.data_ptr(), y.data_ptr(), n, B, K, 0, st),
        }
    moved = {"ef_topk_fused": 12 * n + nb * (K * 6 + 4),
             "ef_topk_fused k_send=2": 12 * n + nb * (K * 6 + 4),
             "topk_pack": 4 * n + nb * (K * 6 + 4), "block_topk": 8 * n}
    rows = {}
    for name, fn in new.items():
        times = {}
        if name in old:
            times["baseline"] = [cs.cuda_ms(old[name], REPS)]
        times["new"] = [cs.cuda_ms(fn, REPS), cs.cuda_ms(fn, REPS)]
        if name in old:
            times["baseline"].append(cs.cuda_ms(old[name], REPS))
        bound_ms = moved[name] / cs.HBM_BYTES_PER_S * 1e3
        rows[name] = {**times, "bound_ms": bound_ms,
                      "gb_per_s": moved[name] / min(times["new"]) / 1e6,
                      "bound_share": bound_ms / min(times["new"])}
        print(f"{name}: {json.dumps(rows[name])}", flush=True)
    if args.yardstick:
        xb = g.view(-1, B)
        ms = cs.cuda_ms(lambda: torch.topk(xb.abs(), K), REPS)
        print(f"yardstick torch.topk(x.view(-1, {B}).abs(), {K}) at n={n}: "
              f"{ms:.3f} ms (not the same function: tie order, C1)",
              flush=True)
    if args.rounds:
        ks = (1, 2, 4, 8, 16, 32)
        i32 = torch.empty(nb * max(ks), dtype=torch.uint16, device=dev)
        v32 = torch.empty(nb * max(ks), device=dev)
        per_k = {k: cs.cuda_ms(lambda k=k: tp.topk_pack(
            g, k, B, out=(i32[:nb * k].view(nb, k), v32[:nb * k].view(nb, k),
                          sc)), REPS) for k in ks}
        slope = (per_k[32] - per_k[1]) / 31
        print(f"topk_pack by k (rounds): {json.dumps(per_k)}; "
              f"{slope:.4f} ms a round from k 1 to 32", flush=True)
    # all-zero blocks (the flat vector's padding): every round ties
    g.zero_()
    e.zero_()
    for name in ("ef_topk_fused", "topk_pack", "block_topk"):
        zeros = {"new_zeros": cs.cuda_ms(new[name], REPS)}
        if name in old:
            zeros["baseline_zeros"] = cs.cuda_ms(old[name], REPS)
        rows[name].update(zeros)
        print(f"{name} on all-zero blocks: {json.dumps(zeros)}", flush=True)
    print(json.dumps({"n": n, "kernels": rows}))
    print(smi)


if __name__ == "__main__":
    main()
