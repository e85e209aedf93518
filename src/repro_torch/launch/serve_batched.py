"""Batched serving (port of `examples/serve_batched.py`): a batch of
prompts decoded into the caches token by token, then new tokens decoded
greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve_batched
        [--arch phi3-medium-14b] [--device cpu] [--metrics] [--mesh 4,2]

The run of JAX's example, with its flags and defaults plus `--device`
(default cuda): the smoke config of `--arch` on a `build_serve_setup` of
shape ("decode", prompt_len + new_tokens, batch), θ0 from PRNGKey(0)
(`Model.init_`, JAX's `init` bit for bit), the prompts
`jax.random.randint(PRNGKey(0), (batch, prompt_len + new_tokens), 0,
vocab)` (`core.prng.randint`, bit for bit), empty caches of
prompt_len + new_tokens slots; the prompt is fed teacher-forced through
`decode_step`, one token a step at positions 0, 1, ..., then each step
takes the last step's greedy token, new_tokens - 1 ... as JAX's loop:
total - 1 steps in all, the sampled tokens those of the steps from
position prompt_len - 1 on.  `--metrics` serves `--requests` requests one
after another (all arriving at once, so a request's queue wait is the
service time of those before it) through `instrument_steps`' decode,
which waits for the device at every step, and writes `serve.jsonl`
(`obs.MetricsLogger`) and a Chrome trace `trace.json` under
`--metrics-dir`; the teacher-forced steps of a request are its prefill
time, the sampled ones its decode time, as in JAX's `serve_with_metrics`.

`--mesh DATA,MODEL` serves on an in-process (data, model) mesh on
`--device` (`launch.mesh.local_mesh`; JAX's example runs on (4, 2)): the
batch over data, θ and the KV rings over model, the greedy token read
from the logits put together (`ServeSetup.full_logits`); the default
1,1 is the one-device run.  The dense archs only (ROADMAP A15).

The archs with an embeddings input (musicgen-large, llava-next-34b) take
(B, 1, d) embeddings, not tokens, so this token loop raises ValueError for
them (JAX's example fails on them too).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.core import prng
from repro_torch.launch.mesh import MeshLayout, local_mesh
from repro_torch.launch.serve import build_serve_setup, instrument_steps

__all__ = ["build_parser", "run", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3-medium-14b",
                    choices=sorted(REGISTRY))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--metrics", action="store_true",
                    help="serve-plane telemetry (repro_torch.obs): "
                         "per-request queue wait + prefill/decode p50/p99 "
                         "histograms, JSONL records and a Chrome trace")
    ap.add_argument("--requests", type=int, default=4,
                    help="--metrics: simulated request arrivals served "
                         "sequentially (queue wait = service start - "
                         "arrival)")
    ap.add_argument("--metrics-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_serve_metrics"),
                    help="where --metrics writes serve.jsonl + trace.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--mesh", default="1,1",
                    help="DATA,MODEL: an in-process mesh on --device "
                         "(1,1: one device)")
    return ap


def _serve(decode, caches, prompts: torch.Tensor, prompt_len: int,
           total: int, full=lambda x: x):
    """JAX's loop: total - 1 decode steps from position 0, teacher-forced
    through the prompt, then greedy (on `full` of a step's logits: the
    whole (B, vocab) of a sharded step).  Returns (the sampled tokens (B,
    total - prompt_len), the sampled steps' logits, caches)."""
    tok = prompts[:, :1]
    generated, logs = [], []
    for t in range(total - 1):
        logits, caches = decode(caches, tok, t)
        if t < prompt_len - 1:
            tok = prompts[:, t + 1:t + 2]          # teacher-forced prompt
        else:
            logits = full(logits)
            tok = logits.argmax(-1)[:, None]
            generated.append(tok)
            logs.append(logits)
    return torch.cat(generated, 1), torch.stack(logs), caches


def run(args, spec=None) -> dict:
    """The example's run (`spec`: another ArchSpec in place of --arch's,
    e.g. its smoke config in f32); returns {"tokens": (batch, new_tokens)
    int32 numpy, "logits": the sampled steps' (new_tokens, batch, vocab)
    f32 numpy} and under --metrics also the summary and the paths
    written."""
    spec = spec or REGISTRY[args.arch]
    cfg = spec.smoke
    if cfg.input_mode != "tokens":
        raise ValueError(f"{args.arch} takes (B, S, d) embeddings, not "
                         f"tokens: this example's token loop cannot serve "
                         f"it (serve it through launch.serve's steps)")
    total = args.prompt_len + args.new_tokens
    shape = ShapeCfg("decode", total, args.batch)
    dm = tuple(int(x) for x in args.mesh.split(","))
    mesh = None if dm == (1, 1) else local_mesh(
        MeshLayout(("data", "model"), dm), args.device)
    setup = build_serve_setup(spec, shape, smoke=True, device=args.device,
                              mesh=mesh)
    if mesh is None:
        setup.model.init_(0)
        dev = setup.model.theta.device
    else:                       # θ0 drawn whole, then cut into the shards
        one = build_serve_setup(spec, shape, smoke=True, device=args.device)
        one.model.init_(0)
        setup.model.load_params(one.model.params())
        del one
        dev = mesh.device
        print(f"mesh (data={dm[0]}, model={dm[1]}) in-process on {dev}")
    prompts = torch.from_numpy(prng.randint(
        prng.PRNGKey(0), (args.batch, total), 0, cfg.vocab_size)).to(
            dev, torch.long)
    if args.metrics:
        return serve_with_metrics(args, setup, prompts, total)
    gen, logs, _ = _serve(setup.decode_step,
                          setup.model.init_caches(args.batch, total),
                          prompts, args.prompt_len, total,
                          setup.full_logits)
    gen = gen.cpu().numpy().astype(np.int32)
    print(f"arch={args.arch} batch={args.batch} "
          f"prompt={args.prompt_len} generated={gen.shape[1]} tokens")
    print("sampled token ids:\n", gen)
    return {"tokens": gen, "logits": logs.float().cpu().numpy()}


def serve_with_metrics(args, setup, prompts: torch.Tensor, total: int
                       ) -> dict:
    """--requests sequential requests through the instrumented decode
    step (JAX's `serve_with_metrics`)."""
    from repro_torch.obs import (MetricsLogger, ServeTelemetry,
                                 run_metadata, span_events,
                                 write_chrome_trace)
    tel = ServeTelemetry()
    rec = tel.recorder
    _, decode = instrument_steps(setup, tel)
    model = setup.model
    arrival = rec.now()        # a burst: every request arrives up front
    gen = None
    for rid in range(args.requests):
        start = rec.now()
        with rec.span("serve/request", tid="requests", request_id=rid):
            n_dec = len(tel.decode_token_s)
            gen, _, _ = _serve(decode,
                               model.init_caches(args.batch, total),
                               prompts, args.prompt_len, total,
                               setup.full_logits)
        # the teacher-forced prompt pass is this request's "prefill",
        # the sampled steps its decode
        pref = sum(tel.decode_token_s[n_dec:n_dec + args.prompt_len - 1])
        dec = sum(tel.decode_token_s[n_dec + args.prompt_len - 1:])
        tel.add_prefill(pref)
        tel.add_request(rid, queue_wait_s=start - arrival, prefill_s=pref,
                        decode_s=dec, tokens=gen.numel())
    mdir = Path(args.metrics_dir)
    meta = run_metadata(arch=args.arch, batch=args.batch,
                        prompt_len=args.prompt_len,
                        new_tokens=args.new_tokens,
                        requests=args.requests, path="serve")
    jsonl = str(mdir / "serve.jsonl")
    with MetricsLogger(jsonl, run_metadata=meta) as logger:
        summary = tel.log_to(logger)
    tpath = str(mdir / "trace.json")
    write_chrome_trace(tpath, span_events(rec.spans, pid=0), metadata=meta)
    print(tel.format_summary())
    print(f"telemetry -> {jsonl}; trace -> {tpath}")
    return {"tokens": gen.cpu().numpy().astype(np.int32),
            "summary": summary, "jsonl": jsonl, "trace": tpath}


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        run(args)
    except ValueError as err:
        ap.error(str(err))


if __name__ == "__main__":
    main()
