"""A dispatch-level cost counter of one step (the port's counterpart of
`repro.launch.hlo_cost`, which reads XLA's compiled HLO).

`OpCounter` is a `TorchDispatchMode`: every aten op the step dispatches,
forward, backward and the remat's recompute alike, passes through it
(a composite op such as einsum as the ops it lowers to, also under
inference mode, where it arrives whole).

  dot flops    2 * prod(result dims) * prod(contracting dims) for mm,
               addmm, bmm, baddbmm, mv, addmv, dot and vdot, which is what
               matmul, einsum and @ lower to; by the dtype of the operands.
               Elementwise flops are ignored, as hlo_cost ignores them.
  bytes_eager  operand and result bytes of every dispatched op except
               views and allocations: an UNFUSED count (each eager op
               reads its inputs from and writes its outputs to memory).
               It is not XLA's `bytes accessed` of fused HLO, and sits
               above what a fused step moves.
  kernels      the hand-written kernels, called through ctypes, are not
               aten ops: each wrapper charges its launch (`kernels.cost`,
               `kernels.common.charge`): launches, bytes and operations.

Loop trip counts (hlo_cost's `known_trip_count`): the sLSTM's steps
(`nn/xlstm.py`, 4096 each way at train_4k) iterate over
`kernels.common.trips(n, device)`.  Under counters that all take the
shortcut (`loop_shortcut=True`, the default), on the meta device, where
no value is computed, and with autograd off, it runs the body once with
every charge multiplied by n; anywhere else it is `range(n)`, so a
counted run on the card unrolls the loop and gives the same counts.  The
sLSTM's scan is an autograd Function whose forward and written-out
backward loops run with autograd off, so training takes the shortcut
too.  Every other loop (the mLSTM's chunks, the SSD's carries) is a
plain `range`, counted trip by trip.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import common

__all__ = ["OpCounter", "dot_flops"]

aten = torch.ops.aten
# op -> index of its first matrix operand (the lhs of the contraction)
_DOTS = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0, aten.vdot: 0,
         aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1}
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided,
           aten.new_empty, aten.new_empty_strided}


def dot_flops(func, args, out) -> float:
    """2 * prod(result dims) * (the lhs's last dim) of a dot op, else 0."""
    i = _DOTS.get(func.overloadpacket)
    if i is None:
        return 0.0
    return 2.0 * out.numel() * args[i].shape[-1]


def _nbytes(xs) -> int:
    return sum(t.numel() * t.element_size() for t in xs
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts one run's dot flops, eager bytes and kernel charges; use as a
    context manager around the work (`with OpCounter() as c: ...`).

    dot_flops: {dtype name: flops}; bytes_eager; dispatches (the ops a
    run dispatches, a shortcut loop's body counted once a trip); seen
    (the dispatches this process made);
    kernels: {name: {"launches", "bytes", "ops", "ops_dtype"}}.
    loop_shortcut: let `common.trips` run a repeated body once on the meta
    device
    (False: count every trip)."""

    def __init__(self, loop_shortcut: bool = True):
        super().__init__()
        self.loop_shortcut = loop_shortcut
        self.scale = 1
        self.dot_flops: Dict[str, float] = {}
        self.bytes_eager = 0.0
        self.dispatches = 0
        self.seen = 0
        self.kernels: Dict[str, Dict] = {}

    def __enter__(self):
        common.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        common.counters.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # einsum, matmul, ... reach the mode whole under inference
            # mode: count the ops they lower to, as outside it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.dispatches += self.scale
        self.seen += 1
        f = dot_flops(func, args, out)
        if f:
            dt = str(args[_DOTS[func.overloadpacket]].dtype).split(".")[-1]
            self.dot_flops[dt] = self.dot_flops.get(dt, 0.0) + f * self.scale
        if not func.is_view:
            b = 0 if func.overloadpacket in _ALLOCS else _nbytes(
                tree_leaves(out))
            self.bytes_eager += (b + _nbytes(tree_leaves((args, kwargs)))
                                 ) * self.scale
        return out

    def charge_kernel(self, name: str, cost) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0.0,
                                           "ops": 0.0,
                                           "ops_dtype": cost.ops_dtype})
        k["launches"] += self.scale
        k["bytes"] += cost.bytes * self.scale
        k["ops"] += cost.ops * self.scale

    @property
    def flops(self) -> float:
        """Dot flops of every dtype."""
        return sum(self.dot_flops.values())

    def record(self) -> Dict:
        return {"dot_flops": self.flops,
                "dot_flops_by_dtype": dict(self.dot_flops),
                "bytes_eager": self.bytes_eager,
                "dispatches": self.dispatches,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}

