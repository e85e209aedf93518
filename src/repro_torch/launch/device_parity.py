"""The train step, and the serving path, on one device against the same
on the CPU.

`step_parity(device, compressor, k_budgets, mode, wire_dtype, num_buckets,
bucket_schedule, phase2_dtype, phase2_sign, arch, param_dtype,
ef_dtype)` builds the f32-compute smoke-size slice of `arch` (default
gemma2-2b; g = 32, N = 4; sign wire, block top-K with k = 8, B = 256,
uniform or with one k budget per rank, global top-K (one block of n / 4
per chunk, k = 16) or the dense wire; values in `wire_dtype`; cocoef,
coco or dense mode; buckets and phase 2 as `TrainRun` takes them; theta
and its gradient in `param_dtype`, e in `ef_dtype`, f32 or bf16, which
runs the kernels' bf16 instances) on the CPU and on `device`, from the
same parameters, and checks two things:

  full step   one `train_step` from the same batch and mask (rank 1 a
              straggler).  Stage 1 sums in another order on each device, so
              acc differs in its last bits.  The loss must agree within 1e-4
              relative, and fewer than 1% of the coordinates of theta may be
              more than 1e-6 apart.  theta must agree within TOL * N *
              (max scale) + 1e-6, the most that flipped decisions near a
              tie can move a coordinate: a sign bit flipped by a near-zero
              accumulator moves c by 2 * (group scale), so TOL = 2 on the
              sign wire; a top-K selection flipped at a near-tie swaps one
              kept coordinate for another, each |c| <= |acc| <= the block
              scale, so TOL = 1 on the top-K wires (summed over the N
              ranks, whose payloads add into ghat).  The dense wire and
              dense mode flip nothing: TOL = 0, theta within 1e-6.
              Phase 2 adds its own: a sign re-pack flips at near-zero
              sums of ghat (|ghat| <= N * max scale), so TOL doubles with
              phase2_sign; a bf16 broadcast rounds ghat, which moves a
              coordinate by up to a bf16 ulp of N * max scale
              (2**-7 * N * max scale more).  A bf16 theta rounds the
              update once more: one bf16 ulp of max |theta| more.
  stage 2     `coded_update` fed the same injected gradients and error
              vectors on both devices.  The kernels equal their plain
              versions bit for bit, so the payload rows, the error vectors
              (updated in place), ghat (written into the gradient buffer,
              or the f32 ghat buffer of bf16 parameters) and theta must
              all be bit-equal (the injected gradients and errors rounded
              to their storage dtypes first): a mix-up of rank rows,
              payload rows or buffers cannot hide in a tolerance.  The
              injected blocks include a zero block, a -0.0 block and, on
              the block top-K wire, k + 1 equal maxima of mixed sign and a
              block of exactly k nonzeros; on the global top-K wire an
              all-zero chunk, a chunk of fewer than k nonzeros (one of them
              denormal) and a tie at the k-th largest |acc| between two
              far-apart positions.  In the coco and dense modes every
              error vector must keep the bits it had before the step.

`serve_parity(device, arch=)` builds the smoke-size serving setup of
`arch` (default gemma2-2b; B = 4 prompts of S = 32 tokens, or seeded bf16
embeddings for the embeddings-input archs; gemma2's local window is 8)
on the CPU and on `device` from the same parameters (JAX's θ0), in f32
and in bf16 compute, and checks the served steps: `prefill_step` (the
flash kernel on the card, its plain version on the CPU; the KV rings and
MLA latents bf16, as JAX's `prefill` keeps them by default) and `steps`
decode steps, at positions S, S + 1, ... (the KV and MLA rings evict
positions 0, 1, ...; the recurrent states advance), each device
decoding from its own caches.  Both devices decode the CPU's greedy
tokens (the embeddings archs: seeded embeddings).  In bf16 the MoE archs
route on the card by the gate ids the CPU's router chose, call by call:
their smoke routers are near uniform, so a hidden state one bf16
rounding away would pick other experts (the f32 runs route on each
device's own router).  Logits and every floating cache leaf must agree
within SERVE_TOL times the largest magnitude of the CPU's tensor: in
f32 1e-5 (f32 sums in other orders, the kernel's online softmax and the
card's expf, tanhf and rsqrtf by ulps, which the recurrent states carry
from step to step); in bf16 4 bf16 ulps (2**-6), because each device
rounds its bf16 products once after its own f32 sums and a flipped last
bit moves everything downstream (the port against JAX on the CPU
differs by one).  With f32 compute the served prefill's bf16 leaves
hold f32 values rounded once, so they must agree elementwise within the
flash kernel's `allowed_error` (one bf16 ulp of the larger magnitude +
2e-5); from the first decode step on, that run reads those rounded
entries, and an entry rounded the other way on the other device moves
the next layer's input, whose new entries then round apart by more (an
H100 against the CPU, 4 steps: nemotron's decode logits 8.2e-5 apart,
new k entries 3.9 bf16 ulps, zamba2's logits 2.5e-4 and its SSM states
1.9e-4), so its decode is held to the bf16 tolerance.  The f32 compute
is held to 1e-5 through the decode by a second f32 run with every cache
in f32 (`model.prefill(cache_dtype=)`), each device again decoding from
its own caches; the recurrent families (hybrid, xLSTM) run it a third
time with the card decoding from the CPU's prefill caches, so that a
state that drifts from step to step on the card shows apart from the
ulps its own prefill started it at.  The cache positions must be equal,
and the greedy tokens wherever the CPU's top-2 logit gap exceeds the
tolerance.  Every check runs before the first miss is raised, so the
message lists every gap.

`moe_repeat(device, dtype)` runs the smoke olmoe-1b-7b MoE layer
(capacity factor 0.5, so assignments are dropped, and one shared expert,
on seeded weights) forward and backward twice on `device`: out, aux, the
dropped count and every gradient must repeat bit for bit (no atomics
decide a float), and on a card nothing inside may synchronise the host
(CUDA's sync debug mode raises on one).

`loss_no_sync(device, arch, dtype)` runs the smoke config of `arch` (its
θ0 and a seeded token batch) forward and backward once on `device`; on a
card nothing inside may synchronise the host (the sync debug mode raises),
so the recurrent families' Python loops (the SSD's chunk carries, the
mLSTM's chunks, the sLSTM's steps) queue their kernels without waiting.

It raises AssertionError on a miss.  `chip_smoke.py` and the `gpu` tests
run it with device="cuda"; on the CPU it also runs against itself.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.serve import build_serve_setup
from repro_torch.launch.train import TrainRun, TrainSetup, build_train_setup
from repro_torch.nn.transformer import tree_map

__all__ = ["cache_leaves", "loss_no_sync", "moe_repeat", "serve_parity",
           "step_parity"]

MASK = (1.0, 0.0, 1.0, 1.0)


FLIP = {"sign": 2.0, "block_topk": 1.0, "topk": 1.0}   # TOL of the docstring
PAYLOAD = {"sign": ("words", "scales"),
           "block_topk": ("idx", "values", "scales"),
           "topk": ("idx", "values", "scales")}


def _setups(device, arch: str, compressor: str,
            k_budgets: Optional[Tuple[int, ...]], mode: str,
            wire_dtype: str, **knobs) -> List[TrainSetup]:
    """Two separate setups, one on the CPU and one on `device`."""
    spec = REGISTRY[arch]
    spec = dataclasses.replace(
        spec, smoke=dataclasses.replace(spec.smoke, dtype="float32"),
        coding=dataclasses.replace(spec.coding, group_size=32,
                                   wire_dtype=wire_dtype))
    run = TrainRun(base_lr=5e-3, compressor=compressor, k_budgets=k_budgets,
                   mode=mode, **knobs)
    return [build_train_setup(spec, ShapeCfg("train", 32, 8), run,
                              smoke=True, device=d)
            for d in ("cpu", device)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu()
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _adversarial_(grads: torch.Tensor, e0: torch.Tensor, L: int,
                  k: Optional[int]) -> None:
    """Blocks of length L at the start of every rank's row: zeros, -0.0,
    and with k (block top-K): k + 1 equal maxima of mixed sign, then a
    block of exactly k nonzeros."""
    grads[:, :L] = 0.0
    e0[:, :L] = 0.0
    grads[:, L:2 * L] = -0.0
    e0[:, L:2 * L] = -0.0
    if k is None:
        return
    tie = grads[:, 2 * L:3 * L]
    tie.mul_(1e-3)
    tie[:, 5:5 + 3 * (k + 1):3] = 2.0
    tie[:, 8:8 + 6 * ((k + 1) // 2):6] = -2.0
    e0[:, 2 * L:3 * L] = 0.0
    grads[:, 3 * L:4 * L] = 0.0
    grads[:, 3 * L + 7:3 * L + 7 + 5 * k:5] = 1.5
    e0[:, 3 * L:4 * L] = 0.0


def _adversarial_chunks_(grads: torch.Tensor, e0: torch.Tensor, nd: int,
                         k: int) -> None:
    """Global top-K's chunks (acc = gamma*g + e, one chunk per block):
    chunk 0 holds a tie at its k-th largest |acc| between two far-apart
    positions (k - 1 larger entries, then 3.0 and -3.0 at its two ends);
    chunk 1 fewer than k nonzeros, one of them denormal; chunk 2 is all
    zero (-0.0 in e)."""
    B = grads.shape[1] // nd
    grads[:, :B].mul_(1e-3)
    e0[:, :B].mul_(1e-3)
    grads[:, 100:100 + k - 1] = 7.0
    e0[:, 100:100 + k - 1] = 0.0
    grads[:, [1, B - 2]] = torch.tensor([3.0, -3.0])
    e0[:, [1, B - 2]] = 0.0
    grads[:, B:2 * B] = 0.0
    e0[:, B:2 * B] = 0.0
    grads[:, B + 9:B + 9 + 3 * (k // 2):3] = -1.25
    grads[:, B + 5] = 1e-40
    grads[:, 2 * B:3 * B] = 0.0
    e0[:, 2 * B:3 * B] = -0.0


def step_parity(device="cuda", seed: int = 0, compressor: str = "sign",
                k_budgets: Optional[Tuple[int, ...]] = None,
                mode: str = "cocoef", wire_dtype: str = "float32",
                num_buckets: int = 1, bucket_schedule: str = "pipelined",
                phase2_dtype: str = "float32", phase2_sign: bool = False,
                arch: str = "gemma2-2b", param_dtype: str = "float32",
                ef_dtype: str = "float32") -> Dict[str, float]:
    """Run both checks (see the module docstring); returns the measured
    gaps of the full step."""
    knobs = dict(num_buckets=num_buckets, bucket_schedule=bucket_schedule,
                 phase2_dtype=phase2_dtype, phase2_sign=phase2_sign,
                 param_dtype=param_dtype, ef_dtype=ef_dtype)
    gdt, edt = getattr(torch, param_dtype), getattr(torch, ef_dtype)
    cpu, dev = _setups(device, arch, compressor, k_budgets, mode,
                       wire_dtype, **knobs)
    folds = cpu.cocoef_cfg.folds
    n_code, n = cpu.n_code, cpu.flat_pad
    cpu.init_state()
    theta0 = cpu.model.theta.clone()
    mask = torch.tensor(MASK)

    res = []
    for s in (cpu, dev):
        s.model.theta.copy_(theta0)
        e = torch.zeros((n_code, n), dtype=edt, device=s.device)
        m = s.train_step(s.model, e, s.make_batch(0), 0, masks=mask)
        res.append((m["loss"].item(), s.model.theta.cpu().float(),
                    s.payload[-1].max().item()))
    (l0, t0, s0), (l1, t1, s1) = res
    d = (t0 - t1).abs()
    out = {"loss_cpu": l0, "loss_device": l1,
           "max_abs_dtheta": d.max().item(),
           "frac_dtheta_over_1e-6": (d > 1e-6).float().mean().item()}
    assert np.isfinite(l1) and abs(l0 - l1) <= 1e-4 * abs(l0), out
    flip = 0.0 if folds else FLIP[compressor]
    if mode != "dense":
        flip = flip * (2.0 if phase2_sign else 1.0) + (
            2.0 ** -7 if phase2_dtype == "bfloat16" else 0.0)
    narrow = 0.0
    if gdt != torch.float32:          # one more rounding of the update
        narrow = 2.0 ** -7 * float(t0.abs().max())
    assert out["max_abs_dtheta"] <= flip * n_code * max(s0, s1) + 1e-6 + \
        narrow, out
    assert out["frac_dtheta_over_1e-6"] < 0.01, out

    rng = np.random.default_rng(seed)
    ccfg = cpu.cocoef_cfg
    L = ccfg.pad_multiple
    mag = np.repeat(np.exp(rng.uniform(-12, 2, (n_code, n // L))), L, 1)
    grads = torch.from_numpy((rng.standard_normal((n_code, n)) * mag)
                             .astype(np.float32))
    e0 = torch.from_numpy((rng.standard_normal((n_code, n)) * mag * 1e-2)
                          .astype(np.float32))
    _adversarial_(grads, e0, L, ccfg.wire.k_max
                  if compressor == "block_topk" and not folds else None)
    if compressor == "topk" and not folds:
        _adversarial_chunks_(grads, e0, n_code,
                             ccfg.wire_format(n, n_code).k_max)
    grads, e0 = grads.to(gdt), e0.to(edt)
    got = []
    for s in (cpu, dev):
        s.model.theta.copy_(theta0)
        g = grads.to(s.device, copy=True)
        e = e0.to(s.device, copy=True)        # updated in place below

        def grad_of(i, s=s, g=g):
            s.model.grad.copy_(g[i])
            return s.model.grad
        ghat = s.coded_update(s.model, grad_of, e, mask.to(s.device), 1)
        names = ("ghat",) if folds else PAYLOAD[compressor]
        got.append({**dict(zip(names, s.payload)), "e": e,
                    "ghat": ghat, "theta": s.model.theta})
    for k in got[0]:
        a, b = _bits(got[0][k]), _bits(got[1][k])
        assert torch.equal(a, b), (
            f"stage 2 on {device} ({arch}, {mode}, {compressor}, budgets "
            f"{k_budgets}, {knobs}): {k} differs from the CPU in "
            f"{int((a != b).sum())} of {a.numel()} entries")
    # cocoef leaves the straggler's error alone, coco and dense every
    # rank's
    for i in (range(n_code) if mode != "cocoef" else [1]):
        assert torch.equal(_bits(got[0]["e"][i]), _bits(e0[i])), \
            f"{mode}: rank {i}'s error vector changed"
    return out


SERVE_SHAPE = ShapeCfg("prefill", 32, 4)
SERVE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def rel_gap(want: torch.Tensor, got: torch.Tensor) -> float:
    """The largest |got - want| relative to the largest |want|."""
    a, b = want.float(), got.float().cpu()
    return (a - b).abs().max().item() / max(a.abs().max().item(), 1e-30)


def _gap(name: str, want: torch.Tensor, got: torch.Tensor, tol: float,
         gaps: Dict[str, float], misses: List[str],
         elementwise: bool = False) -> None:
    """Record the gap of `got` from `want` (`rel_gap`, or with
    `elementwise` in units of flash_attention's `allowed_error` of each
    entry, one bf16 ulp for bf16) and note a miss of `tol`."""
    if elementwise:
        err = (want.float() - got.float().cpu()).abs()
        gap = (err / fa.allowed_error(got.cpu(), want)).max().item()
    else:
        gap = rel_gap(want, got)
    gaps[name] = max(gaps.get(name, 0.0), gap)
    if not (torch.isfinite(got.float()).all() and gap <= tol):
        misses.append(f"{name}: {gap:.3e} (tol {tol:.1e})")


def cache_leaves(tree) -> list:
    """(path, tensor) of every leaf of a cache tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, t) for k in sorted(tree)
                for p, t in cache_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [(f"{i}/{p}" if p else str(i), t) for i, v in enumerate(tree)
                for p, t in cache_leaves(v)]
    return [("", tree)]


def serve_inputs(cfg, B: int, S: int, rng: np.random.Generator
                 ) -> torch.Tensor:
    """Seeded serving inputs: (B, S) tokens, or (B, S, d) bf16 embeddings
    of scale 0.02 for the embeddings-input archs."""
    if cfg.input_mode == "tokens":
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    return (torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)) * 0.02).to(torch.bfloat16)


def _both(routed: bool, cpu_call, dev_call):
    """(cpu_call(), dev_call()); with `routed` the MoE layers of
    dev_call route by the gate ids that cpu_call's chose, call by call
    (`moe.top_k` patched for the two calls)."""
    if not routed:
        return cpu_call(), dev_call()
    from repro_torch.nn import moe as MOE
    top_k, ids = MOE.top_k, collections.deque()
    try:
        MOE.top_k = lambda probs, k: ids.append(top_k(probs, k)) or ids[-1]
        out = cpu_call()
        MOE.top_k = lambda probs, k: ids.popleft().to(probs.device)
        out = out, dev_call()
    finally:
        MOE.top_k = top_k
    assert not ids, "the CPU made more MoE calls than the device"
    return out


def _serve_run(name: str, cpu, dev, prompts, feeds, routed: bool,
               gaps: Dict[str, float], misses: List[str],
               cache_dtype=None, from_cpu: bool = False) -> None:
    """One run of `serve_parity` (see the module docstring): with
    cache_dtype None the served steps, else the prefill with its caches
    in `cache_dtype`; each device decodes from its own caches, or with
    `from_cpu` the card from the CPU's prefill caches.  `feeds` holds
    each step's (B, 1, d) embeddings, or None (tokens: the CPU's greedy
    picks)."""
    on = dev.model.theta.device
    dtype = cpu.model.cfg.dtype
    # f32 compute on the served steps' bf16 rings and latents
    rings = dtype == "float32" and cache_dtype is None

    def prefill(st, x):
        if cache_dtype is None:
            return st.prefill_step(x)
        with torch.inference_mode():
            return st.model.prefill(x, cache_dtype=cache_dtype)
    (l0, c0), (l1, c1) = _both(routed, lambda: prefill(cpu, prompts),
                               lambda: prefill(dev, prompts.to(on)))
    tol = SERVE_TOL[dtype]
    _gap(f"{name} prefill logits", l0, l1, tol, gaps, misses)
    S = prompts.shape[1]
    for t in range(len(feeds) + 1):
        if t:
            if rings:             # from here on it reads rounded entries
                tol = SERVE_TOL["bfloat16"]
            inp = tok[:, None] if feeds[t - 1] is None else feeds[t - 1]
            (l0, c0), (l1, c1) = _both(
                routed, lambda: cpu.decode_step(c0, inp, S + t - 1),
                lambda: dev.decode_step(c1, inp.to(on), S + t - 1))
            _gap(f"{name} decode logits", l0, l1, tol, gaps, misses)
        leaves = list(zip(cache_leaves(c0), cache_leaves(c1)))
        if len(leaves) != len(cache_leaves(c0)) or any(
                a.shape != b.shape or a.dtype != b.dtype
                for (_, a), (_, b) in leaves):
            misses.append(f"{name}: the cache trees differ after {t} "
                          f"decode steps")
        part = "decode" if t else "prefill"
        for (path, a), (_, b) in leaves:
            if not a.is_floating_point():
                if not torch.equal(a, b.cpu()):
                    misses.append(f"{name}: cache {path} differs after {t} "
                                  f"decode steps")
            elif rings and not t and a.dtype == torch.bfloat16:
                _gap(f"{name} prefill cache {path} (bf16 ulps)", a, b, 1.0,
                     gaps, misses, elementwise=True)
            else:
                _gap(f"{name} {part} cache {path}", a, b, tol, gaps, misses)
        top2 = l0.float().topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol * l0.abs().max().item()
        tok = l0.argmax(-1)
        if not torch.equal(tok[sure], l1.argmax(-1).cpu()[sure]):
            misses.append(f"{name}: greedy tokens differ after {t} decode "
                          f"steps")
        if t == 0 and from_cpu:
            c1 = tree_map(lambda a: a.to(on, copy=True), c0)


def serve_parity(device="cuda", seed: int = 0, steps: int = 4,
                 arch: str = "gemma2-2b") -> Dict[str, float]:
    """Run the serving check (see the module docstring); returns the
    measured gaps by run and tensor."""
    spec = REGISTRY[arch]
    B, S = SERVE_SHAPE.global_batch, SERVE_SHAPE.seq_len
    rng = np.random.default_rng(seed)
    prompts = serve_inputs(spec.smoke, B, S, rng)
    feeds = [serve_inputs(spec.smoke, B, 1, rng) for _ in range(steps)]
    if spec.smoke.input_mode == "tokens":
        feeds = [None] * steps
    gaps: Dict[str, float] = {}
    misses: List[str] = []
    for dtype in SERVE_TOL:
        sp = dataclasses.replace(
            spec, smoke=dataclasses.replace(spec.smoke, dtype=dtype))
        cpu, dev = (build_serve_setup(sp, SERVE_SHAPE, smoke=True, device=d)
                    for d in ("cpu", device))
        cpu.model.init_(seed)
        dev.model.theta.copy_(cpu.model.theta)
        routed = bool(spec.smoke.moe_experts) and dtype == "bfloat16"
        run = (prompts, feeds, routed, gaps, misses)
        _serve_run(dtype, cpu, dev, *run)
        if dtype == "float32":
            _serve_run("float32 f32 caches", cpu, dev, *run,
                       cache_dtype=torch.float32)
            if spec.smoke.family in ("hybrid", "xlstm"):
                _serve_run("float32 f32 caches from the CPU's", cpu, dev,
                           *run, cache_dtype=torch.float32, from_cpu=True)
        del cpu, dev
    assert not misses, f"serving {arch} on {device} vs the CPU: " + \
        "; ".join(misses) + f" (all gaps: {gaps})"
    return gaps


def moe_repeat(device="cuda", dtype: str = "bfloat16", seed: int = 0
               ) -> Dict[str, int]:
    """Run the MoE repeat check (see the module docstring); returns the
    dropped assignments and the tensors compared."""
    from repro_torch.nn import moe as MOE
    dev = torch.device(device)
    cfg = dataclasses.replace(REGISTRY["olmoe-1b-7b"].smoke, dtype=dtype,
                              capacity_factor=0.5, moe_shared=1)
    gen = torch.Generator().manual_seed(seed)
    flat = {k: (torch.randn(v, generator=gen) * 0.1).to(dev)
            for k, v in MOE.leaf_shapes(cfg).items()}
    x0 = torch.randn((4, 32, cfg.d_model), generator=gen).to(
        dev, getattr(torch, dtype))
    cot = torch.randn((4, 32, cfg.d_model), generator=gen).to(dev)
    runs = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        p = {k: v for k, v in leaves.items() if "/" not in k}
        p["shared"] = {k.split("/")[1]: v for k, v in leaves.items()
                       if k.startswith("shared/")}
        x = x0.clone().requires_grad_(True)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.set_sync_debug_mode("error")
        try:
            out, aux, dropped = MOE.apply_moe(p, x, cfg)
            (torch.sum(out.float() * cot) + aux).backward()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
        runs.append([out, aux, dropped, x.grad] +
                    [leaves[k].grad for k in sorted(leaves)])
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(_bits(a), _bits(b)), \
            f"MoE layer on {device} ({dtype}): tensor {i} differs between " \
            f"two runs"
    dropped = int(runs[0][2])
    assert dropped > 0, "the capacity factor 0.5 dropped nothing"
    return {"dropped": dropped, "tensors": len(runs[0])}


def loss_no_sync(device="cuda", arch: str = "xlstm-1.3b",
                 dtype: str = "bfloat16", seed: int = 0) -> Dict[str, float]:
    """The no-sync check of the module docstring; returns the loss and the
    gradient's norm (both finite)."""
    from repro_torch.nn.models import Model
    dev = torch.device(device)
    cfg = dataclasses.replace(REGISTRY[arch].smoke, dtype=dtype)
    m = Model(cfg, device=dev)
    m.init_(seed)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen).to(dev)
    w = torch.rand(2, generator=gen).to(dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = m.loss(toks, w)
        loss.backward()
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    out = {"loss": loss.item(), "grad_norm": m.grad.norm().item()}
    assert np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"]), \
        f"{arch} ({dtype}) on {device}: {out}"
    return out
