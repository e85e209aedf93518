"""Serving (prefill / decode) steps on one device (port of
`repro.launch.serve` for the one-card slice), for every arch of
`configs.REGISTRY`.

`build_serve_setup(spec, shape)` builds the model and two steps:
`prefill_step(inputs)` runs the prompt, (B, S) tokens or (B, S, d)
embeddings, through the stack (GQA attention in the hand-written flash
kernel) and returns (last-position logits, caches whose length is the
prompt's); `decode_step(caches, inputs, pos)` feeds one token (or one
embedding) per sequence at absolute position `pos` and updates the caches
in place: the KV and MLA rings at slot pos % cache_len, the Mamba2 and
xLSTM states whole.  Both run under `torch.inference_mode()`.
The caller loads or initialises the parameters (`setup.model.init_(seed)`,
JAX's `init_params(PRNGKey(seed))` bit for bit, or `load_params`).
`instrument_steps` wraps both steps for `obs.ServeTelemetry`.

Not ported: the mesh, the parameter and cache shardings and `input_specs`
(no one-card counterpart).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.common import ArchSpec, ShapeCfg
from repro_torch.nn.models import Model

__all__ = ["LONG_SEQ", "ServeSetup", "build_serve_setup", "cache_len_of",
           "instrument_steps"]

LONG_SEQ = 1 << 19


def cache_len_of(cfg, seq: int) -> int:
    """The serve caches' length: the prompt's, or the sliding window for
    a windowed dense or MoE arch at LONG_SEQ and beyond (gemma2's
    long_500k: every layer's ring capped at the window)."""
    if cfg.family in ("dense", "moe") and cfg.sliding_window and \
            seq >= LONG_SEQ:
        return cfg.sliding_window
    return seq


@dataclasses.dataclass
class ServeSetup:
    model: Model
    cache_len: int
    batch: int
    seq_len: int
    prefill_step: Callable
    decode_step: Callable


def build_serve_setup(spec: ArchSpec, shape: ShapeCfg, smoke: bool = False,
                      device="cuda") -> ServeSetup:
    cfg = spec.smoke if smoke else spec.config
    model = Model(cfg, device=device, with_grad=False)
    B, S = shape.global_batch, shape.seq_len
    cache_len = cache_len_of(cfg, S)

    def prefill_step(inputs: torch.Tensor):
        with torch.inference_mode():
            return model.prefill(inputs)

    def decode_step(caches, inputs: torch.Tensor, pos: int):
        with torch.inference_mode():
            return model.decode_step(caches, inputs, pos)

    return ServeSetup(model=model, cache_len=cache_len, batch=B, seq_len=S,
                      prefill_step=prefill_step, decode_step=decode_step)


def instrument_steps(setup: ServeSetup, telemetry) -> Tuple[Any, Any]:
    """Prefill/decode wrappers feeding an `obs.ServeTelemetry` (JAX's).

    Returns (prefill, decode) with the signatures of `setup.prefill_step`
    and `setup.decode_step`; each call waits for the card (a
    synchronise) and records the wall time as one prefill sample or one
    decode-token sample, inside a `SpanRecorder` span ("serve/prefill",
    "serve/decode"), so the samples land in the Chrome trace too.  The
    wait is the point: the histograms price the step's device time, not
    the launch.  Use them on measurement paths only."""
    rec = telemetry.recorder
    dev = setup.model.theta.device

    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def prefill(inputs):
        with rec.span("serve/prefill", tid="serve"):
            out = setup.prefill_step(inputs)
            wait()
        telemetry.add_prefill(rec.spans[-1]["t1"] - rec.spans[-1]["t0"])
        return out

    def decode(caches, inputs, pos):
        with rec.span("serve/decode", tid="serve"):
            out = setup.decode_step(caches, inputs, pos)
            wait()
        telemetry.add_decode_token(rec.spans[-1]["t1"] - rec.spans[-1]["t0"])
        return out

    return prefill, decode
