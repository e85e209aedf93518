#!/usr/bin/env python3
"""How far the sharded serve's logits sit from the one-device serve's:
gemma2-2b at full width (d 2304, 8 heads, 4 KV heads, hd 288, vocab
256000) and cut depth, bf16, on in-process (data=1, model=4) and
(data=2, model=2) meshes, from one set of seeded parameters at JAX's init
scales.  The prefill, then decode steps fed the one-device run's greedy
tokens; for each step the largest |sharded - one device| over the
largest |one device| (the gap `chip_smoke.py`'s shard phase holds to its
SHARD_TOL), and the greedy tokens that differ where the one-device top-2
gap is clear of twice that.  With --f32 also the one-device serve's own
bf16 error: its gap to the same serve computed in f32 (f32 caches), fed
the same tokens, the scale a bf16 stack's logits move by anyway; and
each mesh's gap to that f32 run (`vs_f32`): the sharded serve is as
accurate as the one-device serve where the two gaps to f32 match.

    PYTHONPATH=src python tools/shard_gap.py [--layers 2,4,8] [--batch 2]
        [--seq 128] [--steps 4] [--device cpu] [--f32]

One JSON line a depth.  On the CPU this takes about 3 GB a layer group
of RAM and a few minutes; the row-parallel sums (wo, w_down, a tied
table) are rank-ordered f32 sums of bf16 partial products rounded once,
the one-device matmul one f32 accumulation rounded once.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import REGISTRY, ShapeCfg  # noqa: E402
from repro_torch.launch.mesh import MeshLayout, local_mesh  # noqa: E402
from repro_torch.launch.serve import build_serve_setup  # noqa: E402

MESHES = ((1, 4), (2, 2))


def params(model, seed: int) -> dict:
    """Seeded normals at JAX's init scales (`tests/_torch_cases.
    shard_params`' rule), written into `model`'s θ."""
    g = torch.Generator().manual_seed(seed)
    for name, v in model.params().items():
        leaf = name.rsplit("/", 1)[-1]
        x = torch.randn(v.shape, generator=g)
        if leaf == "scale":
            x = 1 + x / 10
        elif leaf in ("wq", "wk", "wv"):
            x = x / v.shape[-3] ** 0.5
        elif leaf == "wo":
            x = x / (v.shape[-3] * v.shape[-2]) ** 0.5
        elif leaf != "tok":
            x = x / v.shape[-2] ** 0.5
        v.copy_(x)
    return model.params()


def gap(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def run(setup, prompts, steps: int, feeds=None, cache_dtype=None):
    """The prefill's and `steps` decode steps' whole logits, each step fed
    feeds[t] (None: the greedy token of the step before)."""
    if cache_dtype is None:
        logits, caches = setup.prefill_step(prompts)
    else:
        with torch.inference_mode():
            logits, caches = setup.model.prefill(prompts, cache_dtype)
    out = [setup.full_logits(logits)]
    for t in range(steps):
        tok = out[-1].argmax(-1)[:, None] if feeds is None else feeds[t]
        logits, caches = setup.decode_step(caches, tok, prompts.shape[1] + t)
        out.append(setup.full_logits(logits))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="2,4,8")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32", action="store_true",
                    help="also the one-device serve's gap to its f32 run")
    args = ap.parse_args(argv)
    base = REGISTRY["gemma2-2b"]
    shape = ShapeCfg("prefill", args.seq, args.batch)
    for n in map(int, args.layers.split(",")):
        t0 = time.perf_counter()
        spec = dataclasses.replace(base, config=dataclasses.replace(
            base.config, num_layers=n))
        one = build_serve_setup(spec, shape, device=args.device)
        state = params(one.model, args.seed)
        g = torch.Generator().manual_seed(args.seed + 1)
        prompts = torch.randint(0, spec.config.vocab_size,
                                (args.batch, args.seq), generator=g).to(
                                    args.device)
        want = run(one, prompts, args.steps)
        feeds = [w.argmax(-1)[:, None] for w in want[:-1]]
        rec = {"layers": n, "batch": args.batch, "seq": args.seq,
               "steps": args.steps}
        if args.f32:
            spec32 = dataclasses.replace(spec, config=dataclasses.replace(
                spec.config, dtype="float32"))
            one32 = build_serve_setup(spec32, shape, device=args.device)
            one32.model.theta.copy_(one.model.theta)
            ref = run(one32, prompts, args.steps, feeds, torch.float32)
            rec["one_device_bf16_vs_f32"] = max(gap(a, b) for a, b in
                                                zip(want, ref))
            del one32
        for dm in MESHES:
            mesh = local_mesh(MeshLayout(("data", "model"), dm), args.device)
            setup = build_serve_setup(spec, shape, device=args.device,
                                      mesh=mesh)
            setup.model.load_params(state)
            got = run(setup, prompts, args.steps, feeds)
            gaps = [gap(a, b) for a, b in zip(got, want)]
            top2 = torch.stack(want).float().topk(2, -1).values
            scale = max(w.float().abs().max().item() for w in want)
            clear = (top2[..., 0] - top2[..., 1]) > 2 * max(gaps) * scale
            differ = torch.stack([a.float().argmax(-1) != b.float().argmax(
                -1) for a, b in zip(got, want)])
            rec[f"{dm[0]}x{dm[1]}"] = {
                "gaps": gaps, "max_gap": max(gaps),
                "tokens_differ": int(differ.sum()),
                "tokens_differ_where_clear": int((differ & clear).sum()),
                "clear": int(clear.sum()), "tokens": differ.numel()}
            if args.f32:
                rec[f"{dm[0]}x{dm[1]}"]["vs_f32"] = max(
                    gap(a, b) for a, b in zip(got, ref))
            del setup
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        del one, state
        if args.f32:
            del ref


if __name__ == "__main__":
    main()
