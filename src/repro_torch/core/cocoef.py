"""COCO-EF over flat state on one device (port of `repro.core.cocoef`,
sign wire and cocoef mode).

All N coding ranks share the device.  Each rank's error vector is one row
of an (N, n) tensor, the rank gradients come one at a time through a single
flat gradient buffer, and the step is Algorithm 1:

  for i in ranks:  acc_i = gamma*g_i + e_i;  payload_i = pack(acc_i);
                   e_i <- mask_i ? acc_i - C(acc_i) : e_i     (in place)
  ghat = sum_i mask_i * C(acc_i)                   (one sender-order decode)

The flat order is part of the algorithm: sign groups straddle leaf
boundaries, so the flat vector follows JAX's `tree.leaves` order (dict keys
sorted at every level) and shapes, padded with zeros to `padded_size`.
Parameters and gradients are views into flat buffers (`FlatLayout.views`),
never concatenated copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .collectives import SignWire, coded_aggregate

__all__ = ["CocoEFConfig", "FlatLayout", "flat_layout", "padded_size",
           "cocoef_update"]


@dataclasses.dataclass(frozen=True)
class CocoEFConfig:
    """Algorithm 1 on the sign wire (the port's only wire so far)."""

    group_size: int = 512

    @property
    def wire(self) -> SignWire:
        return SignWire(group_size=self.group_size)

    @property
    def pad_multiple(self) -> int:
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


def cocoef_update(grad_of: Callable[[int], torch.Tensor], e: torch.Tensor,
                  mask: torch.Tensor, gamma, cfg: CocoEFConfig,
                  payload: Tuple[torch.Tensor, torch.Tensor],
                  out: Optional[torch.Tensor] = None,
                  kernel_spans: Optional[List] = None) -> torch.Tensor:
    """One Algorithm-1 update for the N coding ranks sharing this device.

    grad_of(i): rank i's flat (n,) coded gradient; it may return the same
      buffer every time (the slice reuses one gradient buffer), because
      rank i's gradient is consumed before grad_of(i+1) is called.
    e: (N, n) f32 error vectors, updated in place.
    mask: (N,) f32 straggler indicators I_i^t.
    gamma: the learning rate (already inside ghat, eq. 4).
    payload: (words (N, n/32) u32, scales (N, n/g) f32) buffers.
    out: where to write ghat; may be the gradient buffer, which is free
      once the last rank's local step has run.
    kernel_spans: when a list and on CUDA, gets a (start, end) event pair
      around every kernel launch.
    Returns ghat (n,) f32: apply as  params -= ghat."""
    wire = cfg.wire
    N, n = e.shape
    wire.check(n)
    words, scales = payload
    spans = _KernelSpans(kernel_spans, e.device)
    for i in range(N):
        g = grad_of(i)
        with spans:
            wire.fused_local_step(g, e[i], gamma, mask[i],
                                  out=(words[i], scales[i], e[i]))
    with spans:
        return coded_aggregate(wire, (words, scales), mask, out=out)
