#!/usr/bin/env python3
"""Quick check of the flash_attention kernels on one NVIDIA GPU: builds
them and prints ptxas's report for each (registers, spills, wgmma
serialisation advice), holds both routes (bf16 on the tensor cores, f32 on
the CUDA cores) against the plain version at the edges of the bf16
kernel's tiles (128 query rows, 64 keys), and times on request.

    PYTHONPATH=src python tools/flash_check.py [--time] [--library]
        [--profile] [--conditioning [--baseline FILE.cu]]

--time          the bf16 kernel at the serve slice's global and local layer
                shapes (gemma2-2b: B 32, H 8, Hkv 4, S 8192, hd 288,
                softcap 50, window 0 and 4096), and the global one without
                the softcap (what the softcap costs)
--library       beside it, compiled flex_attention (as chip_smoke.py)
--profile       the bf16 kernel at hd 96/192/288 and window 64, softcap 0:
                the MMA work scales with hd, the softmax does not
--conditioning  every f32 case of tests/test_torch_gpu.py's flash sweep
                (the same inputs; hd 16/64/288, softcap and q_scale up to
                scores far past the softcap): kernel and plain version
                against float64 and against each other, in units of
                `allowed_error`; the rows past it and the worst of each
                column per hd, softcap and q_scale
--baseline      another f32 flash_attention.cu (the same launch
                interface), built beside it and held to the same cases

Exits 1 if a case is beyond `flash_attention.allowed_error`.  Much shorter
than chip_smoke.py: the tool for iterating on the kernel.
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


def ptxas_lines(report: str) -> list:
    """ptxas's lines of registers, shared memory, spills and advice (such
    as wgmma serialisation), without the function-property headers."""
    return [ln.strip() for ln in report.splitlines()
            if ln.strip() and "Function properties" not in ln]


def f64_attention(torch, q, k, v, softcap: float, groups: int,
                  window: int = 0):
    """Causal softcapped attention in float64 (the exact answer the f32
    versions round towards)."""
    q, k, v = q.double(), k.double(), v.double()
    k = k.repeat_interleave(groups, 1)
    v = v.repeat_interleave(groups, 1)
    pos = torch.arange(q.shape[2], device=q.device)
    s = q @ k.transpose(-1, -2)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    keep = pos[None, :] <= pos[:, None]
    if window > 0:
        keep &= pos[None, :] > pos[:, None] - window
    s = torch.where(keep, s, -1e30)
    return torch.softmax(s, -1) @ v


def baseline_flash(path: Path):
    """The f32 launcher of another flash_attention.cu, built with the
    port's flags: fn(q, k, v, softcap, window, groups) -> o."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.common import I, VP, stream
    fn = build.library_of_file(path, "flash_attention-baseline") \
        .flash_attention_launch
    fn.argtypes = [VP] * 4 + [I] * 5 + [ctypes.c_float, I, VP]
    fn.restype = I

    def run(q, k, v, softcap, window, groups):
        B, H, S, hd = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                 H, S, hd, groups, float(softcap),
                 window if window > 0 else 1 << 30, stream(q.device))
        if err:
            sys.exit(f"baseline flash_attention: launch error {err}")
        return o
    return run


def conditioning_row(torch, fa, ref, base, flash_inputs, dev, hd, cap, qs,
                     S, window, groups) -> dict:
    """One f32 case of tests/test_torch_gpu.py (the same inputs): the
    kernel, the plain version and (given) the baseline against float64
    and against each other, as shares of `allowed_error`."""
    q, k, v = (t.to(dev) for t in flash_inputs(2, 2, groups, S, hd,
                                                "float32", seed=hd + S,
                                                q_scale=qs))
    outs = {"kernel": fa.flash_attention(q, k, v, softcap=cap,
                                         window=window, groups=groups),
            "plain": ref.flash_attention_ref(q, k, v, cap, window, groups)}
    if base is not None:
        outs["baseline"] = base(q, k, v, cap, window, groups)
    exact = f64_attention(torch, q, k, v, cap, groups, window)
    row = {"hd": hd, "softcap": cap, "q_scale": qs, "S": S,
           "window": window, "groups": groups}
    pairs = [("kernel", "plain"), ("kernel", "f64"), ("plain", "f64")]
    if base is not None:
        pairs += [("baseline", "plain"), ("baseline", "f64")]
    for a, b in pairs:
        x = outs[a]
        y = exact if b == "f64" else outs[b]
        err = (x.double() - y.double()).abs()
        row[f"{a}_vs_{b}"] = (err / fa.allowed_error(x, y.float()).double()
                              ).max().item()
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="also time the bf16 kernel at hd 96/192/288 and "
                    "window 64 (softcap 0), to split MMA from fixed costs")
    ap.add_argument("--conditioning", action="store_true",
                    help="for the GPU tests' f32 cases with scores far past "
                    "the softcap (hd 288, q_scale 100), the error of the "
                    "kernel and of the plain version against float64, in "
                    "units of `allowed_error`")
    ap.add_argument("--baseline", type=Path,
                    help="with --conditioning: another f32 "
                    "flash_attention.cu held to the same cases")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.kernels import build, flash_attention as fa, ref
    from repro_torch.kernels.common import flash_routes

    dev = torch.device("cuda", 0)
    print(f"device: {cs.smi_line()}", flush=True)
    for name in ("flash_attention_sm90", "flash_attention"):
        t0 = time.perf_counter()
        report = build.ptxas_report(name)
        print(f"build {name}: {time.perf_counter() - t0:.2f} s", flush=True)
        for ln in ptxas_lines(report):
            print(f"  {ln}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    cases = [(B, Hkv, g, S, hd, cap, qs, w, dt)
             for dt in (torch.bfloat16, torch.float32)
             for S in (1, 63, 64, 65, 127, 128, 129, 1000)
             for hd in (16, 64, 288)
             for (B, Hkv, g) in ((2, 2, 1), (1, 2, 2), (2, 1, 4))
             for cap, qs in ((0.0, 1.0), (50.0, 100.0))
             for w in (0, 1, 64)]
    cases.append((1, 2, 2, 8192, 288, 50.0, 1.0, 4096, torch.bfloat16))
    worst = 0.0
    for B, Hkv, g, S, hd, cap, qs, w, dt in cases:
        q, k, v = cs.attention_inputs(torch, gen, dev, B, Hkv, g, S, hd, dt,
                                      qs)
        got = fa.flash_attention(q, k, v, softcap=cap, window=w, groups=g)
        again = fa.flash_attention(q, k, v, softcap=cap, window=w, groups=g)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, cap, w, g)
        err = (got.float() - want.float()).abs()
        share = (err / fa.allowed_error(got, want)).max().item()
        worst = max(worst, share)
        same = cs.same(got, again)
        if not (share <= 1.0 and same
                and bool(torch.isfinite(got.float()).all())):
            bad += 1
            print(f"FAIL {dt} B={B} Hkv={Hkv} groups={g} S={S} hd={hd} "
                  f"softcap={cap} q_scale={qs} window={w}: max err "
                  f"{err.max().item():.3e}, {share:.3f} of the allowance, "
                  f"repeat same bits {same}", flush=True)
    print(f"checked {len(cases)} cases, {bad} beyond the tolerance; worst "
          f"{worst:.3f} of the allowance; routes {dict(flash_routes)}",
          flush=True)

    if args.time:
        from repro_torch.configs import REGISTRY
        cfg = REGISTRY["gemma2-2b"].config
        B, S, hd = cs.SERVE_BATCH, cs.SERVE_SEQ, cfg.head_dim
        H, Hkv, cap = cfg.num_heads, cfg.num_kv_heads, cfg.attn_softcap
        q, k, v = cs.attention_inputs(torch, gen, dev, B, Hkv, H // Hkv, S,
                                      hd, torch.bfloat16)
        for w, c in ((0, cap), (cfg.sliding_window, cap), (0, 0.0)):
            flops = 4 * hd * B * H * cs.attention_pairs(S, w)
            ms = cs.cuda_ms(lambda: fa.flash_attention(
                q, k, v, softcap=c, window=w, groups=H // Hkv), 5)
            row = {"window": w, "softcap": c, "ms": ms,
                   "tflop_per_s": flops / ms / 1e9,
                   "bound_ms": flops / cs.BF16_OPS_PER_S * 1e3}
            if args.library:
                lib = cs.library_attention(torch, q, k, v, cap, w, H // Hkv,
                                           kernel_options=cs.FLEX_OPTIONS)
                row["library_ms"] = cs.cuda_ms(lib, 5)
            print(json.dumps(row), flush=True)
    if args.conditioning:
        sys.path.insert(0, str(ROOT / "tests"))
        from _torch_cases import flash_inputs
        base = baseline_flash(args.baseline) if args.baseline else None
        worst = {}
        for hd in (16, 64, 288):
            for cap, qs in ((0.0, 1.0), (50.0, 1.0), (50.0, 100.0)):
                for S in (1, 63, 64, 65, 127, 128, 129, 1000, 4096):
                    for window in (0, 1, 64, 5000):
                        for groups in (1, 2, 4):
                            row = conditioning_row(
                                torch, fa, ref, base, flash_inputs, dev, hd,
                                cap, qs, S, window, groups)
                            w = worst.setdefault(f"hd {hd} softcap {cap} "
                                                 f"q_scale {qs}", {})
                            for col, v in row.items():
                                if col.endswith(("plain", "f64")):
                                    w[col] = max(w.get(col, 0.0), v)
                            if row["kernel_vs_plain"] > 1.0 or \
                                    row["plain_vs_f64"] > 1.0:
                                print(json.dumps(row), flush=True)
        print("conditioning, worst of each column over the GPU tests' f32 "
              "cases (the rows above: kernel_vs_plain or plain_vs_f64 past "
              "the allowance):", flush=True)
        for key, w in worst.items():
            print(f"  {key}: {json.dumps(w)}", flush=True)
    if args.profile:
        B, S, H, Hkv = cs.SERVE_BATCH, cs.SERVE_SEQ, 8, 4
        for hd, w in ((96, 0), (192, 0), (288, 0), (288, 64)):
            q, k, v = cs.attention_inputs(torch, gen, dev, B, Hkv, H // Hkv,
                                          S, hd, torch.bfloat16)
            ms = cs.cuda_ms(lambda: fa.flash_attention(
                q, k, v, softcap=0.0, window=w, groups=H // Hkv), 5)
            flops = 4 * hd * B * H * cs.attention_pairs(S, w)
            print(json.dumps({"hd": hd, "window": w, "softcap": 0.0,
                              "ms": ms, "tflop_per_s": flops / ms / 1e9}),
                  flush=True)
            del q, k, v
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
