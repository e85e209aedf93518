"""Serving (prefill / decode) steps (port of `repro.launch.serve`), for
every arch of `configs.REGISTRY` on one device, and for the dense family
(minus FSDP) on a (data, model) mesh.

`build_serve_setup(spec, shape, device=, mesh=None)` builds the model and
two steps: `prefill_step(inputs)` runs the prompt, (B, S) tokens or (B, S,
d) embeddings, through the stack (GQA attention in the hand-written flash
kernel) and returns (last-position logits, caches whose length is the
prompt's); `decode_step(caches, inputs, pos)` feeds one token (or one
embedding) per sequence at absolute position `pos` and updates the caches
in place: the KV and MLA rings at slot pos % cache_len, the Mamba2 and
xLSTM states whole.  Both run under `torch.inference_mode()`.
The caller loads or initialises the parameters (`setup.model.init_(seed)`,
JAX's `init_params(PRNGKey(seed))` bit for bit, or `load_params`).
`instrument_steps` wraps both steps for `obs.ServeTelemetry`.

With a mesh (a `launch.mesh.DeviceMesh`, in-process or over processes)
`setup.model` is a `nn.models.ShardedModel` (load the whole θ with
`load_params`: each device gets its shard), the steps run under
`sharding.ctx.use_mesh(mesh)` and take the global batch: each device
reads its block over the data axes (`batch_sharding`, JAX's `_dp_spec`),
as int32 tokens, JAX's dtype.  They return a list with an entry a local
device: its logits block (`prefill_out_shardings[0]`, JAX's `vshard`:
batch over dp, vocab over model where it divides) and its caches (the
ring layout of `rules.serve_cache_specs`, ROADMAP C17); `full_logits`
puts the logits together.  `param_shardings` (spec, shard shape) and
`cache_shardings` say what each device holds; `input_specs(kind)` is
`serve_specs` on the mesh's layout, JAX's `input_specs` (the dry run's
function).  Families other than dense, and the FSDP arch, raise
NotImplementedError on a mesh (ROADMAP A15).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.common import ArchSpec, ShapeCfg
from repro_torch.launch.mesh import MeshLayout
from repro_torch.nn import transformer as T
from repro_torch.nn.models import Model, ShardedModel
from repro_torch.sharding import ctx, rules

__all__ = ["LONG_SEQ", "ServeSetup", "build_serve_setup", "cache_len_of",
           "instrument_steps", "Arg", "arg", "part_bytes", "serve_specs",
           "dp_spec"]

LONG_SEQ = 1 << 19
ONE_DEVICE = MeshLayout(("data", "model"), (1, 1))
dp_spec = rules.dp_spec
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int32": 4, "uint32": 4,
             "int64": 8}


def cache_len_of(cfg, seq: int) -> int:
    """The serve caches' length: the prompt's, or the sliding window for
    a windowed dense or MoE arch at LONG_SEQ and beyond (gemma2's
    long_500k: every layer's ring capped at the window)."""
    if cfg.family in ("dense", "moe") and cfg.sliding_window and \
            seq >= LONG_SEQ:
        return cfg.sliding_window
    return seq


# --------------------------------------------------------------------------
# argument specs (JAX's `input_specs`, shapes only)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Arg:
    """One argument leaf: global shape, dtype name, spec, and the shape
    of one device's shard."""

    shape: Tuple[int, ...]
    dtype: str
    spec: Tuple[Any, ...]
    shard: Tuple[int, ...]

    @property
    def bytes_per_device(self) -> int:
        return math.prod(self.shard) * _ITEMSIZE[self.dtype]


def arg(shape, dtype: str, spec, mesh: MeshLayout) -> Arg:
    shape = tuple(int(d) for d in shape)
    return Arg(shape, dtype, tuple(spec), rules.shard_shape(shape, spec,
                                                            mesh))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def part_bytes(parts: Dict[str, Any]) -> Dict[str, int]:
    """Per-device bytes of every argument part."""
    return {k: sum(a.bytes_per_device for a in _leaves(v))
            for k, v in parts.items()}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).split(".")[-1]


def serve_specs(spec: ArchSpec, shape: ShapeCfg, mesh: MeshLayout,
                kind: str, smoke: bool = False) -> Dict[str, Any]:
    """JAX's `ServeSetup.input_specs(kind)` on `mesh`, shapes only:
    cache_len, the batch's dp axes (`dp_spec`) and `parts`: params, and
    for a decode the caches (`init_caches`' tree, `rules.cache_specs`),
    the one-token inputs and pos; for a prefill the prompt."""
    cfg = spec.smoke if smoke else spec.config
    B, S = shape.global_batch, shape.seq_len
    cache_len = cache_len_of(cfg, S)
    pshapes = T.param_shapes(cfg)
    pspecs = rules.param_specs(pshapes, cfg, mesh, fsdp=spec.coding.fsdp)
    bspec = dp_spec(mesh, B)
    batch_axes = rules.batch_axes(mesh, B)
    parts = {"params": {n: arg(s, cfg.param_dtype, pspecs[n], mesh)
                        for n, s in pshapes.items()}}
    tok = cfg.input_mode == "tokens"
    if kind == "decode":
        caches = T.init_caches(cfg, B, cache_len, torch.bfloat16, "meta")
        cspecs = rules.cache_specs(caches, cfg, mesh, batch_axes, B)
        parts["caches"] = T.tree_map(
            lambda t, s: arg(t.shape, _dtype_name(t.dtype), s, mesh),
            caches, cspecs)
        parts["inputs"] = (arg((B, 1), "int32", (bspec, None), mesh) if tok
                           else arg((B, 1, cfg.d_model), "bfloat16",
                                    (bspec, None, None), mesh))
        parts["pos"] = arg((), "int32", (), mesh)
    else:
        parts["inputs"] = (arg((B, S), "int32", (bspec, None), mesh) if tok
                           else arg((B, S, cfg.d_model), "bfloat16",
                                    (bspec, None, None), mesh))
    return {"cfg": cfg, "cache_len": cache_len, "batch_axes": batch_axes,
            "parts": parts}


# --------------------------------------------------------------------------
# the setup
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ServeSetup:
    model: Any                  # Model, or ShardedModel on a mesh
    cache_len: int
    batch: int
    seq_len: int
    prefill_step: Callable
    decode_step: Callable
    mesh: Any = None            # the DeviceMesh, or None
    param_shardings: Any = None     # name -> (spec, shard shape)
    cache_shardings: Any = None     # the ring specs (rules.serve_cache_specs)
    batch_sharding: Any = None      # the batch's dp entry (dp_spec)
    prefill_out_shardings: Any = None   # (logits spec, cache specs)
    decode_out_shardings: Any = None
    input_specs: Optional[Callable] = None  # kind -> serve_specs(...)

    def full_logits(self, parts) -> torch.Tensor:
        """The whole (B, vocab) logits from a sharded step's blocks
        (gathered from every process in the process form)."""
        if self.mesh is None:
            return parts
        return rules.unshard(self.mesh.all_parts(parts),
                             self.prefill_out_shardings[0],
                             self.mesh.layout)


def _batch_blocks(mesh, spec, x: torch.Tensor) -> list:
    """Each local device's block of the global batch x over the dp axes,
    tokens as int32 (JAX's dtype), on the mesh's device."""
    if not x.is_floating_point():
        x = x.to(torch.int32)
    full = (spec,) + (None,) * (x.dim() - 1)
    return [rules.shard_of(x, full, mesh.layout, i).to(mesh.device)
            for i in mesh.indices]


def build_serve_setup(spec: ArchSpec, shape: ShapeCfg, smoke: bool = False,
                      device="cuda", mesh=None) -> ServeSetup:
    cfg = spec.smoke if smoke else spec.config
    B, S = shape.global_batch, shape.seq_len
    cache_len = cache_len_of(cfg, S)
    layout = ONE_DEVICE if mesh is None else mesh.layout
    input_specs = functools.partial(serve_specs, spec, shape, layout,
                                    smoke=smoke)
    if mesh is None:
        model = Model(cfg, device=device, with_grad=False)

        def prefill_step(inputs: torch.Tensor):
            with torch.inference_mode():
                return model.prefill(inputs)

        def decode_step(caches, inputs: torch.Tensor, pos: int):
            with torch.inference_mode():
                return model.decode_step(caches, inputs, pos)

        return ServeSetup(model=model, cache_len=cache_len, batch=B,
                          seq_len=S, prefill_step=prefill_step,
                          decode_step=decode_step, input_specs=input_specs)

    if spec.coding.fsdp:
        raise NotImplementedError(
            f"{spec.arch_id} shards its weights over data too (FSDP): its "
            f"just-in-time gather (sharding.ctx.gather_block) is ROADMAP "
            f"A15")
    model = ShardedModel(cfg, mesh)
    bspec = dp_spec(layout, B)
    meta = T.init_caches(cfg, B, cache_len, torch.bfloat16, "meta")
    cspecs = rules.serve_cache_specs(meta, cfg, layout,
                                     rules.batch_axes(layout, B), B)
    m = layout.axis_sizes.get("model", 1)
    vshard = (bspec, "model" if cfg.vocab_size % m == 0 else None)

    def prefill_step(inputs: torch.Tensor):
        with torch.inference_mode(), ctx.use_mesh(mesh):
            return model.prefill(_batch_blocks(mesh, bspec, inputs))

    def decode_step(caches, inputs: torch.Tensor, pos: int):
        with torch.inference_mode(), ctx.use_mesh(mesh):
            return model.decode_step(caches, _batch_blocks(mesh, bspec,
                                                           inputs), pos)

    return ServeSetup(
        model=model, cache_len=cache_len, batch=B, seq_len=S,
        prefill_step=prefill_step, decode_step=decode_step, mesh=mesh,
        param_shardings=rules.param_shardings(T.param_shapes(cfg), cfg,
                                              layout),
        cache_shardings=cspecs, batch_sharding=bspec,
        prefill_out_shardings=(vshard, cspecs),
        decode_out_shardings=(vshard, cspecs), input_specs=input_specs)


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
    dev = (setup.mesh.device if setup.mesh is not None
           else setup.model.theta.device)

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
