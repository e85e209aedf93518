"""COCO-EF over flat state on one device (port of `repro.core.cocoef`:
the cocoef, coco and dense modes, on the sign, block top-K, global top-K
and dense wires).

All N coding ranks share the device.  Each rank's error vector is one row
of an (N, n) tensor, the rank gradients come one at a time through a single
flat gradient buffer, and the step is Algorithm 1:

  for i in ranks:  acc_i = gamma*g_i + e_i;  payload_i = pack(acc_i);
                   e_i <- mask_i ? acc_i - C(acc_i) : e_i     (in place)
  ghat = sum_i mask_i * C(acc_i)                   (one sender-order decode)

With per-rank budgets on the block top-K wire (`k_per_block` a tuple) the
same fused step takes rank i's budget k_i: its values beyond k_i are +0 and
C(acc_i) is unpacked from that payload before it feeds the error, as JAX's
budget branch (`repro/core/cocoef.py:308-318`).

mode="coco" is the paper's baseline without error feedback (JAX
`cocoef.py:286-296`): acc_i = gamma*g_i, payload_i = budget_i(pack(acc_i))
(the pack kernel takes the budget), the same decode, and e is neither read
nor written.

mode="dense" is the stochastic-gradient-coding baseline (JAX
`cocoef.py:278-281`): acc_i = gamma*g_i, ghat = sum_i mask_i * acc_i, e
neither read nor written.  JAX sums with a psum across the mesh; on one
device the sum is taken in rank order from +0.0 (ROADMAP C5).

On the dense wire (compressor "identity") and in dense mode there is no
(N, n) payload: the ranks run one after another, so rank i's
mask_i * C(acc_i) is added into an f32 accumulator (the payload's only
leaf, (n,)) as soon as it is made, which is the sender-order decode bit for
bit.  The accumulator is ghat.

The flat order is part of the algorithm: sign groups straddle leaf
boundaries, so the flat vector follows JAX's `tree.leaves` order (dict keys
sorted at every level) and shapes, padded with zeros to `padded_size`.
Parameters and gradients are views into flat buffers (`FlatLayout.views`),
never concatenated copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import ref

from .collectives import DenseWire, Wire, build_wire, coded_aggregate

__all__ = ["CocoEFConfig", "FlatLayout", "flat_layout", "padded_size",
           "cocoef_update", "MODES", "check_mode"]

MODES = ("cocoef", "coco", "dense")


def check_mode(mode: str) -> None:
    """Raise ValueError unless `mode` is one of MODES."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")


@dataclasses.dataclass(frozen=True)
class CocoEFConfig:
    """Algorithm 1 on one wire (JAX's names and defaults).

    mode: "cocoef" (error feedback), "coco" (none) or "dense" (no
      compression: the SGC baseline).
    compressor: "sign", "block_topk", "topk" (global top-K) or "identity"
      (the dense wire).
    topk_k: the global top-K budget, split evenly over the chunks.
    k_per_block / block_size: the block top-K wire's kept coordinates per
      block (an int, or one budget per coding rank) and block length.
    wire_dtype: the sparse wires' value dtype, the dense wire's dtype."""

    group_size: int = 512
    mode: str = "cocoef"
    compressor: str = "sign"
    topk_k: int = 64
    k_per_block: Union[int, Tuple[int, ...]] = 8
    block_size: int = 256
    wire_dtype: str = "float32"

    def __post_init__(self):
        check_mode(self.mode)
        if self.topk_k < 1:
            raise ValueError(f"need topk_k >= 1, got {self.topk_k}")
        if self.compressor != "topk":
            self.wire  # validates the compressor and the wire's knobs
        else:
            ref.wire_dtype(self.wire_dtype)

    def wire_format(self, n: int = 0, nd: int = 1) -> Wire:
        """The wire for `n` coordinates over `nd` all_to_all chunks (only
        global top-K depends on them: one block per chunk)."""
        return build_wire(self.compressor, group_size=self.group_size,
                          k_per_block=self.k_per_block,
                          block_size=self.block_size, topk_k=self.topk_k,
                          value_dtype=self.wire_dtype, n=n, nd=nd)

    @property
    def wire(self) -> Wire:
        """The wire of a compressor that does not depend on the flat size
        (global top-K needs `wire_format(n, nd)`)."""
        return self.wire_format()

    @property
    def folds(self) -> bool:
        """Whether ghat is summed into one accumulator rank by rank (the
        dense wire, dense mode) instead of decoded from (N, ...) payloads."""
        return self.mode == "dense" or self.compressor == "identity"

    @property
    def pad_multiple(self) -> int:
        """Flat-size alignment: the sign group, joined with the sparse
        block on the block top-K wire (JAX `cocoef.py:106-113`)."""
        if self.compressor == "block_topk":
            return math.lcm(self.group_size, self.block_size)
        return self.group_size


def padded_size(total: int, chunk_ranks: int, group_size: int,
                num_buckets: int = 1) -> int:
    mult = chunk_ranks * group_size * num_buckets
    return math.ceil(total / mult) * mult


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each named leaf lives in the padded flat f32 vector."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    total: int
    padded: int

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """name -> view of `flat` with the leaf's shape (shares storage)."""
        if flat.shape != (self.padded,):
            raise ValueError(f"flat buffer has shape {tuple(flat.shape)}, "
                             f"layout needs ({self.padded},)")
        return {n: flat[o:o + math.prod(s)].view(s)
                for n, s, o in zip(self.names, self.shapes, self.offsets)}


def leaf_order(names: Sequence[str]) -> List[str]:
    """JAX `tree.leaves` order of a nested dict whose leaves are named by
    their '/'-joined key paths: keys sorted level by level."""
    return sorted(names, key=lambda n: tuple(n.split("/")))


def flat_layout(shapes: Dict[str, Tuple[int, ...]], chunk_ranks: int,
                group_size: int, num_buckets: int = 1) -> FlatLayout:
    names = tuple(leaf_order(shapes))
    offs, off = [], 0
    for n in names:
        offs.append(off)
        off += math.prod(shapes[n])
    return FlatLayout(names=names,
                      shapes=tuple(tuple(shapes[n]) for n in names),
                      offsets=tuple(offs), total=off,
                      padded=padded_size(off, chunk_ranks, group_size,
                                         num_buckets))


class _KernelSpans:
    """CUDA event pairs around the stage-2 kernels (device time)."""

    def __init__(self, sink: Optional[List], device: torch.device):
        self.sink = sink if device.type == "cuda" else None

    def __enter__(self):
        if self.sink is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc):
        if self.sink is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.sink.append((self._start, end))
        return False


def cocoef_update(grad_of: Callable[[int], torch.Tensor],
                  e: Optional[torch.Tensor], mask: torch.Tensor, gamma,
                  cfg: CocoEFConfig, payload: Tuple[torch.Tensor, ...],
                  out: Optional[torch.Tensor] = None,
                  kernel_spans: Optional[List] = None) -> torch.Tensor:
    """One Algorithm-1 update (or, with cfg.mode "coco", one update without
    error feedback, or with "dense" the uncompressed baseline) for the N
    coding ranks sharing this device.

    grad_of(i): rank i's flat (n,) coded gradient; it may return the same
      buffer every time (the slice reuses one gradient buffer), because
      rank i's gradient is consumed before grad_of(i+1) is called.  On the
      per-rank budget branch, on the global top-K and dense wires and in
      the coco and dense modes the buffer is overwritten (with acc_i or
      C(acc_i)).
    e: (N, n) f32 error vectors, updated in place; not read in the coco
      and dense modes (may be None there).
    mask: (N,) f32 straggler indicators I_i^t.
    gamma: the learning rate (already inside ghat, eq. 4).
    payload: the wire's payload buffers stacked over ranks: sign (words
      (N, n/32) u32, scales (N, n/g) f32); block or global top-K (idx
      (N, n/B, k), values (N, n/B, k), scales (N, n/B) f32); the dense
      wire and dense mode (ghat (n,) f32,): the accumulator.
    out: where to write ghat; may be the gradient buffer, which is free
      once the last rank's local step has run.  Not used where ghat is
      the accumulator (the dense wire, dense mode).
    kernel_spans: when a list and on CUDA, gets a (start, end) event pair
      around every rank's local step (in coco mode its gamma*g and pack)
      and around the decode.
    Returns ghat (n,) f32: apply as  params -= ghat."""
    N = mask.shape[0]
    spans = _KernelSpans(kernel_spans, mask.device)
    if cfg.folds:
        return _folded_update(grad_of, e, mask, gamma, cfg, payload[0],
                              spans)
    wire = None
    for i in range(N):
        g = grad_of(i)
        if wire is None:          # global top-K's block is n / N
            wire = cfg.wire_format(g.numel(), N)
            wire.check(g.numel(), N)
            if wire.has_rank_budgets() and len(wire.k_per_block) != N:
                raise ValueError(
                    f"wire has {len(wire.k_per_block)} per-rank budgets, "
                    f"the coding collective has {N} ranks")
        rows = tuple(p[i] for p in payload)
        with spans:
            if cfg.mode == "coco":
                # one f32 rounding, as JAX's gamma * g_local; no c, no e
                acc = g.mul_(ref.as_f32(gamma, g))
                wire.fused_pack(acc, out=rows, rank=i)
            else:
                wire.fused_local_step(g, e[i], gamma, mask[i],
                                      out=rows + (e[i],), rank=i)
    with spans:
        return coded_aggregate(wire, payload, mask, out=out)


def _folded_update(grad_of, e, mask, gamma, cfg: CocoEFConfig,
                   ghat: torch.Tensor, spans: _KernelSpans) -> torch.Tensor:
    """`cocoef_update` where ghat is one accumulator: rank by rank, C(acc_i)
    is made in the gradient buffer and mask_i * C(acc_i) added into ghat,
    from +0.0 in rank order.  Dense mode is the f32 identity without error
    feedback: acc_i = gamma*g_i (one rounding) is C(acc_i)."""
    wire = cfg.wire if cfg.mode != "dense" else DenseWire()
    with spans:
        ghat.zero_()
    for i in range(mask.shape[0]):
        g = grad_of(i)
        with spans:
            if cfg.mode == "cocoef":
                c = wire.fused_local_step_(g, e[i], gamma, mask[i])
            else:
                c = wire.roundtrip_(g.mul_(ref.as_f32(gamma, g)))
            wire.fold_(ghat, c, mask[i])
    return ghat
