"""The active mesh (the port's counterpart of `repro.sharding.ctx`).

`use_mesh(mesh)` makes a `launch.mesh.DeviceMesh` the active mesh inside
its block (a `contextvars` context, so threads and tasks keep their own);
`active_mesh()` returns it, or None outside any block.  The sharded serve
steps (`launch.serve`) run under it, and the dense stack's sharded prefill
and decode (`nn.transformer.sharded_prefill`, `sharded_decode_step`) take
their collectives from it.

`constrain(x, spec)` is the identity.  In JAX it is a GSPMD layout hint
(`with_sharding_constraint`) at the residual stream and the recurrent
carries; an eager program has no compiler to hint, and the port lays out
every tensor itself: the residual stream replicated over the model axis
(Megatron-style tensor parallelism), the batch over the data axes.  It is
kept so that code written against JAX's call sites reads the same.

`gather_block` stands where JAX's just-in-time weight gather for the FSDP
archs (qwen1.5-110b) stands, and raises: FSDP is not ported (ROADMAP A15),
and `launch.serve.build_serve_setup` refuses an FSDP arch on a mesh before
any layer runs.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

__all__ = ["use_mesh", "active_mesh", "constrain", "gather_block"]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """`mesh` (a `DeviceMesh`, or None) active inside the block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[object]:
    return _ACTIVE.get()


def constrain(x, spec):
    """The identity (see the module docstring): JAX's sharding hint has
    no eager counterpart."""
    return x


def gather_block(block_params, compute_dtype):
    """JAX's FSDP weight gather inside the layer loop: not ported."""
    raise NotImplementedError(
        "FSDP's just-in-time weight gather (qwen1.5-110b) is not ported: "
        "ROADMAP A15")
