#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device     needs torch.cuda; prints the card's name and power limit
  2. build      compiles every CUDA source of src/repro_torch with nvcc
  3. kernels    each kernel against its plain PyTorch version at n = 2**28
                with adversarial groups (words and decode exact, scales
                <= 2 ulp), then again at the slice's n (past 2**31) in the
                train step's buffer layout, chunk by chunk, and timed there
                with CUDA events
  4. reference  the f32 smoke-size train step on the card against the CPU
                (repro_torch/launch/device_parity.py): the full step
                within stated tolerances, stage 2 on injected gradients
                bit for bit
  5. train      the slice: gemma2-2b at full width, N = 4 coding ranks on
                the card, d = 2, sign wire g = 512, 5 COCO-EF steps; the
                kernel launch counts are reset just before and read just
                after, and must be 4 x steps and steps
Then it prints the kernel table as one JSON line, the card's
`nvidia-smi` name and power limit, and as the last line
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

STEPS = 5
N_CODE = 4
SEQ_LEN, GLOBAL_BATCH = 512, 4
GROUP = 512
CHECK_N = 1 << 28
CHUNK = 1 << 28           # the plain versions run in chunks this long
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, at 700 W
F32_OPS_PER_S = 67e12         # H100 SXM data sheet, f32 outside tensor cores
MAX_ULP = 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, after one
    warm-up call (CUDA events)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ulps(a, b):
    import torch
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def spacing(x):
    """One ulp of |x| (f32), denormals included."""
    import torch
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def adversarial_(g, e, G: int, gamma: float) -> None:
    """First groups: all zeros, all -0.0, denormals, exact cancellation."""
    g[:G] = 0.0
    e[:G] = 0.0
    g[G:2 * G] = -0.0
    e[G:2 * G] = -0.0
    sgn = (g[2 * G:3 * G] >= 0).float() * 2 - 1
    g[2 * G:3 * G] = sgn * 1e-40
    e[2 * G:3 * G] = -sgn * 3e-41
    g[3 * G:4 * G] = 1.0
    e[3 * G:4 * G] = -gamma


def compare_ef(torch, want, got, what: str) -> dict:
    """want = the plain (words, scales, c, e'), got = the kernel's (c may
    be None).  Words exact, scales <= MAX_ULP ulp; c and e' exact where
    the scales agree, else within MAX_ULP ulp of the scale (plus one
    rounding of e')."""
    w0, s0, c0, e0 = want
    w1, s1, c1, e1 = got
    if not torch.equal(w0, w1):
        fail(f"{what}: words differ")
    du = ulps(s0, s1)
    if du.max().item() > MAX_ULP:
        fail(f"{what}: scales {du.max().item()} ulp apart")
    same = (du == 0).repeat_interleave(GROUP)
    tol = spacing(torch.maximum(s0, s1)).repeat_interleave(GROUP) * MAX_ULP
    worst = {"max_ulp": du.max().item(), "max_abs_err": 0.0}
    for name, a, b, extra in (("c", c0, c1, 0.0), ("e'", e0, e1, None)):
        if b is None:
            continue
        if not torch.equal(a[same].view(torch.int32),
                           b[same].view(torch.int32)):
            fail(f"{what}: {name} differs where scales agree")
        if extra is None:   # one rounding of e' = acc - c itself
            extra = spacing(torch.maximum(a.abs(), b.abs()))
        if bool(((a - b).abs() > tol + extra).any()):
            fail(f"{what}: {name} beyond the scale-ulp bound")
        worst["max_abs_err"] = max(worst["max_abs_err"],
                                   (a - b).abs().max().item())
    return worst


def merge(a: dict, b: dict) -> dict:
    return {k: max(a[k], b[k]) for k in a}


def check_ef(torch, ref, sp, gen, dev) -> dict:
    gamma = 0.37
    g = torch.randn(CHECK_N, device=dev, generator=gen)
    e = torch.randn(CHECK_N, device=dev, generator=gen) * 0.01
    mag = torch.exp(torch.rand(CHECK_N // GROUP, device=dev, generator=gen)
                    * 25 - 20).repeat_interleave(GROUP)
    g.mul_(mag)
    e.mul_(mag)
    adversarial_(g, e, GROUP, gamma)
    worst = {"max_ulp": 0, "max_abs_err": 0.0}
    for mask in (1.0, 0.0):
        got = sp.ef_sign_fused(g, e, gamma, mask, GROUP, want_c=True)
        torch.cuda.synchronize()
        want = ref.ef_sign_fused_ref(g, e, gamma, mask, GROUP)
        worst = merge(worst, compare_ef(
            torch, want, got, f"ef_sign_fused at n={CHECK_N} (mask={mask})"))
        if mask == 0.0 and not torch.equal(got[3], e):
            fail("ef_sign_fused: a straggler's e changed")
        del got, want
    return worst


def check_decode(torch, ref, sp, gen, dev) -> dict:
    words = torch.randint(0, 2 ** 32, (N_CODE, CHECK_N // 32), device=dev,
                          generator=gen, dtype=torch.int64).to(torch.uint32)
    scales = torch.rand((N_CODE, CHECK_N // GROUP), device=dev,
                        generator=gen)
    scales[0, :4] = 0.0
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    got = sp.sign_decode_reduce(words, scales, mask, GROUP)
    torch.cuda.synchronize()
    want = ref.sign_decode_reduce_ref(words, scales, mask, GROUP)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail("sign_decode_reduce differs from the sender-order sum")
    return {"max_ulp": 0, "max_abs_err": (got - want).abs().max().item()}


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def ef_at_slice(torch, ref, sp, gen, dev, n: int) -> dict:
    """ef_sign_fused at the slice's n (past 2**31 elements) in the train
    step's layout: the error is a row of a 2-D buffer updated in place and
    the payload goes into rows of the (N, n/32) and (N, n/g) buffers.  Row
    0 of `e` keeps the inputs, row 1 is the one the kernel updates.  A
    straggler launch (mask 0, payload row 2) and a live one (mask 1, row 1)
    are held against the plain version chunk by chunk, then the live one is
    timed.  Adversarial groups sit at the start and past 2**31."""
    gamma = 5e-3
    g = torch.randn(n, device=dev, generator=gen)
    e = torch.empty((2, n), device=dev)
    e[0].normal_(generator=gen)
    mag = torch.exp(torch.rand(n // GROUP, device=dev, generator=gen)
                    * 25 - 20).repeat_interleave(GROUP)
    g.mul_(mag)
    e[0].mul_(mag).mul_(0.01)
    del mag
    for a in (0, n - 4 * GROUP):
        adversarial_(g[a:a + 4 * GROUP], e[0, a:a + 4 * GROUP], GROUP, gamma)
    e[1].copy_(e[0])
    gamma_t = torch.tensor(gamma, device=dev)   # a device scalar, as in
    # the train step: no launch copies it from the host
    words = torch.zeros((N_CODE, n // 32), dtype=torch.uint32, device=dev)
    scales = torch.zeros((N_CODE, n // GROUP), device=dev)
    masks = torch.tensor([1.0, 0.0], device=dev)
    worst = {"max_ulp": 0, "max_abs_err": 0.0}
    for row, m in ((2, masks[1]), (1, masks[0])):
        sp.ef_sign_fused(g, e[1], gamma_t, m, GROUP,
                         out=(words[row], scales[row], e[1]))
        torch.cuda.synchronize()
        what = f"ef_sign_fused at n={n} (mask={m.item()})"
        if m.item() == 0.0 and not torch.equal(e[1].view(torch.int32),
                                                e[0].view(torch.int32)):
            fail(f"{what}: a straggler's e changed")
        for i in range(0, n, CHUNK):
            j = min(i + CHUNK, n)
            want = ref.ef_sign_fused_ref(g[i:j], e[0, i:j], gamma_t, m,
                                         GROUP)
            got = (words[row, i // 32:j // 32],
                   scales[row, i // GROUP:j // GROUP], None, e[1, i:j])
            worst = merge(worst, compare_ef(torch, want, got, what))
            del want

    ms = cuda_ms(lambda: sp.ef_sign_fused(
        g, e[1], gamma_t, masks[0], GROUP, out=(words[1], scales[1], e[1])),
        10)

    def plain():
        for i in range(0, n, CHUNK):
            ref.ef_sign_fused_ref(g[i:i + CHUNK], e[0, i:i + CHUNK], gamma_t,
                                  masks[0], GROUP)
    plain_ms = cuda_ms(plain, 2)
    moved = 12 * n + n / 8 + 4 * n / GROUP
    b, by = bound(moved, 6 * n)
    return {**worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": by, "gb_per_s": moved / ms / 1e6}


def decode_at_slice(torch, ref, sp, gen, dev, n: int) -> dict:
    """sign_decode_reduce at the slice's n over the (N, n/32) and (N, n/g)
    payload buffers of the train step: held against the plain version
    chunk by chunk (exact), then timed."""
    words = torch.randint(0, 2 ** 32, (N_CODE, n // 32), device=dev,
                          generator=gen, dtype=torch.int64).to(torch.uint32)
    scales = torch.rand((N_CODE, n // GROUP), device=dev, generator=gen)
    scales[0, :4] = 0.0
    scales[2, -4:] = 0.0
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    out = torch.empty(n, device=dev)
    sp.sign_decode_reduce(words, scales, mask, GROUP, out=out)
    torch.cuda.synchronize()
    for i in range(0, n, CHUNK):
        j = min(i + CHUNK, n)
        want = ref.sign_decode_reduce_ref(words[:, i // 32:j // 32],
                                          scales[:, i // GROUP:j // GROUP],
                                          mask, GROUP)
        if not torch.equal(out[i:j].view(torch.int32),
                           want.view(torch.int32)):
            fail(f"sign_decode_reduce at n={n} differs from the "
                 f"sender-order sum in [{i}, {j})")
        del want

    ms = cuda_ms(lambda: sp.sign_decode_reduce(words, scales, mask, GROUP,
                                               out=out), 10)

    def plain():
        for i in range(0, n, CHUNK):
            ref.sign_decode_reduce_ref(
                words[:, i // 32:(i + CHUNK) // 32],
                scales[:, i // GROUP:(i + CHUNK) // GROUP], mask, GROUP)
    plain_ms = cuda_ms(plain, 2)
    moved = N_CODE * (n / 8 + 4 * n / GROUP) + 4 * N_CODE + 4 * n
    b, by = bound(moved, 3 * N_CODE * n)
    return {"max_ulp": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "gb_per_s": moved / ms / 1e6}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch next to {Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import REGISTRY, ShapeCfg
    from repro_torch.core.cocoef import padded_size
    from repro_torch.kernels import build, ref, sign_pack as sp
    from repro_torch.launch.device_parity import step_parity
    from repro_torch.launch.train import TrainRun, build_train_setup
    from repro_torch.nn.transformer import num_params

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"device: {smi}", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)",
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {"ef_sign_fused": check_ef(torch, ref, sp, gen, dev),
              "sign_decode_reduce": check_decode(torch, ref, sp, gen, dev)}
    print(f"kernels vs plain at n={CHECK_N}: {json.dumps(checks)}",
          flush=True)
    spec = REGISTRY["gemma2-2b"]
    n = padded_size(num_params(spec.config), N_CODE, GROUP)
    at_slice = {"ef_sign_fused": ef_at_slice(torch, ref, sp, gen, dev, n)}
    torch.cuda.empty_cache()
    at_slice["sign_decode_reduce"] = decode_at_slice(torch, ref, sp, gen,
                                                     dev, n)
    torch.cuda.empty_cache()
    print(f"kernels vs plain and times at n={n}, train layout: "
          f"{json.dumps(at_slice)}", flush=True)

    try:
        parity = step_parity("cuda")
    except AssertionError as err:
        fail(f"smoke-size step on the card vs the CPU: {err}")
    print(f"reference: {json.dumps(parity)}", flush=True)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    setup = build_train_setup(spec, ShapeCfg("train", SEQ_LEN, GLOBAL_BATCH),
                              TrainRun(base_lr=5e-3), n_code=N_CODE,
                              device=dev)
    if setup.flat_pad != n:
        fail(f"flat size {setup.flat_pad} != {n}")
    e = setup.init_state()
    batches = [setup.make_batch(t) for t in range(STEPS)]
    torch.cuda.synchronize()
    sp.reset_launches()
    for t in range(STEPS):
        spans = []
        t_start = time.perf_counter()
        m = setup.train_step(setup.model, e, batches[t], t,
                             kernel_spans=spans)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t_start
        kernel_ms = sum(a.elapsed_time(b) for a, b in spans)
        print(json.dumps({"step": t, "loss": loss, "step_s": step_s,
                          "kernel_ms": kernel_ms,
                          "mask": m["mask"].tolist()}), flush=True)
        if not math.isfinite(loss):
            fail(f"step {t}: loss {loss}")
    launches = dict(sp.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"train: gemma2-2b {spec.config.num_layers} layers, flat {n}, "
          f"peak memory "
          f"{peak} B ({peak / 1e9:.2f} GB)", flush=True)
    if launches["ef_sign_fused"] != N_CODE * STEPS or \
            launches["sign_decode_reduce"] != STEPS:
        fail(f"launch counts {launches}, want ef_sign_fused="
             f"{N_CODE * STEPS}, sign_decode_reduce={STEPS}")
    for name, rows in (("theta", [setup.model.theta]), ("e", list(e))):
        if not all(bool(torch.isfinite(r).all()) for r in rows):
            fail(f"non-finite {name} after training")

    src = "src/repro_torch/kernels/csrc/sign_pack.cu"
    meta = {
        "ef_sign_fused": ("src/repro/kernels/sign_pack.py:112",
                          "kernels/sign_pack.py::ef_sign_fused"),
        "sign_decode_reduce": ("src/repro/kernels/sign_pack.py:162",
                               "kernels/sign_pack.py::sign_decode_reduce"),
    }
    kernels = []
    for name, (replaces, tpu) in meta.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "tpu_kernel": tpu,
            "launches": launches[name],
            "max_abs_err": max(checks[name]["max_abs_err"],
                               at_slice[name]["max_abs_err"]),
            "max_ulp": max(checks[name]["max_ulp"], at_slice[name]["max_ulp"]),
            "ms": at_slice[name]["ms"], "plain_ms": at_slice[name]["plain_ms"],
            "bound_ms": at_slice[name]["bound_ms"],
            "bound_by": at_slice[name]["bound_by"],
            "gb_per_s": at_slice[name]["gb_per_s"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
