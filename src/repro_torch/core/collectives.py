"""The wires and the coded aggregate of COCO-EF (port of the wires of
`repro.core.collectives`, with the name -> wire mapping of
`repro.core.plan.build_wire`).

SignWire, SparseWire and DenseWire are the wire contract: `pack`/`unpack`
are the plain semantics, `fused_pack`, `fused_local_step` and
`decode_reduce` route through the kernels (`repro_torch.kernels.ops`: the
Hopper kernels for CUDA tensors, the plain versions for CPU tensors).
Global top-K (compressor "topk") is a SparseWire with one block per
all_to_all chunk, which the kernels' wrappers take through the global
route of `kernels/topk_pack.py`.  DenseWire (the identity compressor, f32
or bf16 on the wire) has no kernel in JAX either: plain PyTorch on both
devices.

The coded collective in two forms
---------------------------------
The JAX collective spreads the coding ranks over mesh axes, the last of
which (nd ranks) is the chunk axis, and aggregates in three parts
(`repro/core/collectives.py:613-657`): an all_to_all that sends chunk j of
every sender's payload to rank j, a per-chunk `decode_reduce` over the
senders (then, on a grid with an outer axis, a psum of the chunk sums
across it), and an all_gather of the chunk sums (phase 2: f32, bf16, or
re-packed on the sign wire).

The group form is that collective over `torch.distributed` process groups
(`launch.mesh.CodingGrid`), one process per coding rank:
`coded_allreduce_start` issues one `all_to_all_single` per payload leaf on
the chunk group (async; the leaf's chunk rows travel as bytes, so u32 sign
words and u16 indices need no dtype support from gloo or NCCL) and returns
an `InFlightAggregate` whose `finish` decodes, sums across the outer group
and runs phase 2.  No float sum is left to the collective library: the
decode sums the chunk's senders in order from +0, the outer sum is an
all_gather of the chunk sums added in rank order from +0 (XLA:CPU's psum
gives those bits, ROADMAP C5), and `dense_allreduce` is the same path on
`DenseWire(float32)`.  No all_reduce is used.

The one-device form is `coded_aggregate`: with every coding rank on one
device the three parts are one `decode_reduce` over the full payloads.
Decode-reduce works coordinate by coordinate: out[x] depends only on the
senders' payload entries for x's group or block and the mask, summed in
sender order.  Chunks are whole groups and whole blocks (n is padded to a
multiple of nd * pad_multiple, and pad_multiple is lcm(group_size,
block_size) on the block top-K wire), so every chunk's payload is a
contiguous slice of the full one, and the all_gather concatenates the
chunk sums in chunk order without touching their bits.  On a 1-D grid
(no outer axis) the group form's chunk j is therefore the one-device
decode restricted to chunk j's coordinates, summed over the same senders
in the same order from the same +0: the two forms, and the reference
loop's `_masked_sum`, agree bit for bit.  On a grid with an outer axis the
group form sums hierarchically, as JAX does (each chunk's senders, then
the outer groups), which is another association of the same sum.  The
dense wire goes one step further on one device: the ranks run one after
another, so each rank's m_i * C(acc_i) is added into one f32 accumulator
as soon as it is made (`DenseWire.fold_`), which is the sender-order sum
bit for bit without an (N, n) payload.

A `DryGroup` in place of a process group (`launch.mesh.dry_grid`, the dry
run's) sends nothing: each all_to_all and all_gather the group form would
issue is recorded in `DryGroup.calls` (the op, its result bytes and the
group's size), so one device's stage 2 runs on meta tensors and shows
the traffic it would put on the wire.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops, ref
from repro_torch.kernels.topk_pack import index_dtype

__all__ = ["SignWire", "SparseWire", "DenseWire", "WIRES", "build_wire",
           "wire_for_compressor", "wire_bytes_sign", "coded_aggregate",
           "CodingCollectiveConfig", "InFlightAggregate",
           "coded_allreduce_start", "two_phase_coded_allreduce",
           "dense_allreduce", "phase2_local_", "DryGroup"]

CHUNK = 1 << 28      # the dense wire's plain passes bound their temporaries
#                      to this many elements


def wire_bytes_sign(n: int, group_size: int) -> int:
    """Bytes on the wire for one rank's phase-1 payload."""
    return n // 8 + 4 * (n // group_size)


Payload = Tuple[torch.Tensor, ...]   # sign: (words, scales); sparse: (idx,
#                                      values, scales); dense: (values,);
#                                      leading dim N when stacked over
#                                      senders


def _check_flat(wire, n: int, nd: int) -> None:
    a = wire.alignment()
    if n <= 0 or n % (nd * a):
        raise ValueError(
            f"{type(wire).__name__}: flat size {n} must be a positive "
            f"multiple of chunk_count*alignment = {nd}*{a}; pad upstream")


@dataclasses.dataclass(frozen=True)
class SignWire:
    """Grouped sign quantization: 1 bit/coordinate + an f32 scale (mean
    |x|) per group of `group_size`; sign(+-0) := +1."""

    group_size: int = 512

    def pack(self, x: torch.Tensor) -> Payload:
        return ref.sign_pack_ref(x, self.group_size)

    def unpack(self, payload: Payload) -> torch.Tensor:
        words, scales = payload
        return ref.sign_unpack_ref(words, scales, self.group_size)

    def wire_bytes(self, n: int) -> int:
        return wire_bytes_sign(n, self.group_size)

    def rank_wire_bytes(self, n: int, num_ranks: int) -> np.ndarray:
        """(num_ranks,) int64 phase-1 bytes per rank: uniform."""
        return np.full((num_ranks,), int(self.wire_bytes(n)), np.int64)

    def alignment(self) -> int:
        return self.group_size

    def check(self, n: int, nd: int = 1) -> None:
        _check_flat(self, n, nd)

    def has_rank_budgets(self) -> bool:
        return False

    def apply_rank_budget(self, payload: Payload, rank: int) -> Payload:
        """Identity: the sign wire has no per-rank budgets."""
        return payload

    def payload_n(self, payload: Payload) -> int:
        return payload[0].shape[-1] * 32

    def fused_pack(self, x: torch.Tensor, out: Optional[Payload] = None,
                   rank: Optional[int] = None, gamma=None) -> Payload:
        """pack(gamma * x) (x when gamma is None; x f32 or bf16, the
        product rounded once in f32) through the kernel, written into `out`
        = (words, scales) when given.  `rank` is ignored: the sign wire has
        no budgets."""
        return ops.sign_pack(x, self.group_size, out=out, gamma=gamma)

    def fused_local_step(self, g: torch.Tensor, e: torch.Tensor, gamma,
                         mask_self, want_c: bool = False,
                         out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]] = None,
                         rank: Optional[int] = None):
        """acc = gamma*g + e; payload = pack(acc); c = C(acc);
        e_new = mask_self ? acc - c : e, in one pass over g and e (f32 or
        bf16 each; e_new in e's dtype, rounded once).  `out` = (words,
        scales, e_new) buffers; e_new may alias e.  `rank` is ignored.
        Returns (payload, c or None, e_new)."""
        words, scales, c, e_new = ops.ef_sign_fused(
            g, e, gamma, mask_self, self.group_size, want_c=want_c, out=out)
        return (words, scales), c, e_new

    def decode_reduce(self, payloads: Payload, sender_mask: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sum_i sender_mask_i * unpack(payload_i), in sender order."""
        words, scales = payloads
        return ops.sign_decode_reduce(words, scales, sender_mask,
                                      self.group_size, out=out)


@dataclasses.dataclass(frozen=True)
class SparseWire:
    """Block top-K on the wire.  Per block of `block_size` coordinates:
      indices (nb, k) u16 (u32 when block_size > 65536): in-block positions
              of the k largest |x|, magnitude descending, first occurrence
              winning ties (`lax.top_k`'s order);
      values  (nb, k) value_dtype: the kept x / scale;
      scales  (nb,) f32: the block max |x|, 1.0 for an all-zero block.

    `k_per_block` may be a per-rank tuple: the payload is shaped by k_max
    on every rank and rank i's values beyond its own budget are +0
    (`apply_rank_budget` on a plain payload; the kernels, given the rank,
    write them so); `rank_wire_bytes` charges each rank its own k."""

    k_per_block: Union[int, Tuple[int, ...]] = 8
    block_size: int = 256
    value_dtype: str = "float32"

    def __post_init__(self):
        ks = self.k_per_block
        if isinstance(ks, (list, tuple, np.ndarray)):
            ks = tuple(int(k) for k in np.asarray(ks).reshape(-1))
            if not ks:
                raise ValueError("per-rank k_per_block must be non-empty")
            object.__setattr__(self, "k_per_block", ks)
        else:
            ks = (int(ks),)
        for k in ks:
            if not 0 < k <= self.block_size:
                raise ValueError(f"need 0 < k_per_block <= block_size, got "
                                 f"{k} / {self.block_size}")
        ref.wire_dtype(self.value_dtype)

    @property
    def k_max(self) -> int:
        """The largest per-rank budget: the payload's k dimension."""
        ks = self.k_per_block
        return max(ks) if isinstance(ks, tuple) else ks

    @property
    def index_dtype(self) -> torch.dtype:
        return index_dtype(self.block_size)

    def has_rank_budgets(self) -> bool:
        return isinstance(self.k_per_block, tuple)

    def for_rank(self, rank: int) -> "SparseWire":
        """The one-budget wire rank `rank` transmits."""
        if not self.has_rank_budgets():
            return self
        return dataclasses.replace(self,
                                   k_per_block=int(self.k_per_block[rank]))

    def apply_rank_budget(self, payload: Payload, rank: int) -> Payload:
        """Zero rank `rank`'s values beyond its budget, in place (a block's
        top-k indices are distinct, so this is exactly the k_i payload)."""
        if self.has_rank_budgets():
            payload[1][..., self.k_per_block[rank]:] = 0
        return payload

    def k_send(self, rank: Optional[int]) -> int:
        """The slots rank `rank` fills with values (k_max when None or when
        the wire has one budget)."""
        if rank is None or not self.has_rank_budgets():
            return self.k_max
        return int(self.k_per_block[rank])

    def rank_wire_bytes(self, n: int, num_ranks: int) -> np.ndarray:
        if not self.has_rank_budgets():
            return np.full((num_ranks,), int(self.wire_bytes(n)), np.int64)
        if len(self.k_per_block) != num_ranks:
            raise ValueError(f"wire has {len(self.k_per_block)} per-rank "
                             f"budgets, asked for {num_ranks} ranks")
        return np.asarray([self.for_rank(i).wire_bytes(n)
                           for i in range(num_ranks)], np.int64)

    def pack(self, x: torch.Tensor) -> Payload:
        idx, val, scales = ref.topk_pack_ref(x, self.k_max, self.block_size)
        return (idx.to(self.index_dtype),
                val.to(ref.wire_dtype(self.value_dtype)), scales)

    def unpack(self, payload: Payload) -> torch.Tensor:
        idx, values, scales = payload
        return ref.topk_unpack_ref(idx, values, scales, self.block_size)

    def wire_bytes(self, n: int) -> int:
        idx_b = 2 if self.block_size <= (1 << 16) else 4
        val_b = ref.wire_dtype(self.value_dtype).itemsize
        return (n // self.block_size) * (self.k_max * (idx_b + val_b) + 4)

    def alignment(self) -> int:
        return self.block_size

    def check(self, n: int, nd: int = 1) -> None:
        _check_flat(self, n, nd)

    def payload_n(self, payload: Payload) -> int:
        return payload[2].shape[-1] * self.block_size

    def fused_pack(self, x: torch.Tensor, out: Optional[Payload] = None,
                   rank: Optional[int] = None, gamma=None) -> Payload:
        """pack(gamma * x) (x when gamma is None; x f32 or bf16, the
        product rounded once in f32) through the kernel, k_max slots, with
        rank `rank`'s budget applied (its values past k_i are +0; None: no
        budget), written into `out` = (idx, values, scales) when given."""
        return ops.topk_pack(x, self.k_max, self.block_size,
                             self.value_dtype, out=out,
                             k_send=self.k_send(rank), gamma=gamma)

    def fused_local_step(self, g: torch.Tensor, e: torch.Tensor, gamma,
                         mask_self, want_c: bool = False,
                         out: Optional[Tuple[torch.Tensor, ...]] = None,
                         rank: Optional[int] = None,
                         acc: Optional[torch.Tensor] = None):
        """acc = gamma*g + e; payload = pack(acc) with rank `rank`'s
        budget; c = unpack(payload) (values rounded to the wire dtype,
        times scale); e_new = mask_self ? acc - c : e, in one pass over g
        and e (f32 or bf16 each; e_new in e's dtype, rounded once): with a
        budget, JAX's budget branch (`repro/core/cocoef.py:308-318`).
        `out` = (idx, values, scales, e_new) buffers; e_new may alias e.
        `acc`: the global route's f32 acc buffer (`ops.ef_topk_fused`).
        Returns (payload, c or None, e_new)."""
        idx, val, scales, c, e_new = ops.ef_topk_fused(
            g, e, gamma, mask_self, self.k_max, self.block_size,
            self.value_dtype, want_c=want_c, out=out,
            k_send=self.k_send(rank), acc=acc)
        return (idx, val, scales), c, e_new

    def decode_reduce(self, payloads: Payload, sender_mask: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sum_i sender_mask_i * unpack(payload_i), in sender order."""
        idx, val, scales = payloads
        return ops.topk_decode_reduce(idx, val, scales, sender_mask,
                                      self.block_size, out=out)


@dataclasses.dataclass(frozen=True)
class DenseWire:
    """Uncompressed: the flat vector, in f32 (the SGC baseline's wire,
    C = identity) or narrowed to bf16 (C(x) = f32(bf16(x))).

    JAX has no kernel for it (`repro/kernels/ops.py::dense_decode_reduce`),
    so every method is plain PyTorch, on either device.  The one-device
    step runs `local_chunks` (cocoef, or coco without e) and `fold_`s each
    chunk's c into the ghat accumulator; that is JAX's base
    `fused_local_step` (`repro/core/collectives.py:185-207`) and its
    sender-order `decode_reduce`, rank by rank."""

    value_dtype: str = "float32"

    def __post_init__(self):
        ref.wire_dtype(self.value_dtype)

    @property
    def vdt(self) -> torch.dtype:
        return ref.wire_dtype(self.value_dtype)

    def pack(self, x: torch.Tensor) -> Payload:
        return (x.to(self.vdt),)

    def unpack(self, payload: Payload) -> torch.Tensor:
        return payload[0].to(torch.float32)

    def wire_bytes(self, n: int) -> int:
        return n * self.vdt.itemsize

    def rank_wire_bytes(self, n: int, num_ranks: int) -> np.ndarray:
        """(num_ranks,) int64 phase-1 bytes per rank: uniform."""
        return np.full((num_ranks,), int(self.wire_bytes(n)), np.int64)

    def alignment(self) -> int:
        return 1

    def check(self, n: int, nd: int = 1) -> None:
        _check_flat(self, n, nd)

    def payload_n(self, payload: Payload) -> int:
        return payload[0].shape[-1]

    def has_rank_budgets(self) -> bool:
        return False

    def roundtrip_(self, x: torch.Tensor) -> torch.Tensor:
        """x <- C(x) = f32(vdt(x)) in place (nothing to do on f32)."""
        if self.vdt != torch.float32:
            for i in range(0, x.numel(), CHUNK):
                xc = x[i:i + CHUNK]
                xc.copy_(xc.to(self.vdt))
        return x

    def local_chunks(self, g: torch.Tensor, e: Optional[torch.Tensor],
                     gamma, mask_self):
        """The Algorithm-1 local step a CHUNK at a time: yields (slice,
        c = C(acc) of the chunk, f32), acc = gamma*g + e (two roundings;
        g and e f32 or bf16, widened), having set e <- mask_self ? acc - c
        : e on the chunk (in e's dtype, rounded once).  With e None (COCO,
        dense mode) acc = gamma*g, rounded once.  g is not written; c is a
        fresh f32 tensor (the caller may overwrite it)."""
        gam = ref.as_f32(gamma, g)
        keep = ref.as_f32(mask_self, g) > 0
        for i in range(0, g.numel(), CHUNK):
            sl = slice(i, i + CHUNK)
            acc = g[sl].to(torch.float32) * gam
            if e is None:
                yield sl, self.unpack(self.pack(acc))
                continue
            acc.add_(e[sl])
            c = self.unpack(self.pack(acc))
            e[sl] = torch.where(keep, acc - c, e[sl])
            yield sl, c

    @staticmethod
    def fold_(ghat: torch.Tensor, c: torch.Tensor, mask_i) -> torch.Tensor:
        """ghat <- ghat + mask_i * c, the product rounded on its own (one
        step of the sender-order scan); c is overwritten with mask_i * c."""
        return ghat.add_(c.mul_(ref.as_f32(mask_i, c)))

    def decode_reduce(self, payloads: Payload, sender_mask: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sum_i sender_mask_i * f32(values_i) over stacked payloads, in
        sender order from +0.0 (JAX's `dense_decode_reduce_scan`), written
        into `out` when given."""
        ghat = ref.dense_decode_reduce_ref(payloads[0], sender_mask)
        return ghat if out is None else out.copy_(ghat)


Wire = Union[SignWire, SparseWire, DenseWire]
WIRES = ("sign", "block_topk", "topk", "identity")


def build_wire(compressor: str, *, group_size: int = 512,
               k_per_block: Union[int, Tuple[int, ...]] = 8,
               block_size: int = 256, topk_k: int = 64,
               value_dtype: str = "float32", n: int = 0, nd: int = 1,
               num_buckets: int = 1) -> Wire:
    """The wire of a compressor name and its knobs for one bucket of `n`
    coordinates over `nd` all_to_all chunks (the mapping of
    `repro.core.plan.build_wire`).  Global top-K is one block per chunk
    with the global budget topk_k split over the chunks and buckets."""
    if compressor == "sign":
        return SignWire(group_size=group_size)
    if compressor == "block_topk":
        return SparseWire(k_per_block=k_per_block, block_size=block_size,
                          value_dtype=value_dtype)
    if compressor == "topk":
        block = n // nd
        kb = -(-topk_k // (nd * num_buckets))
        return SparseWire(k_per_block=min(block, kb), block_size=block,
                          value_dtype=value_dtype)
    if compressor == "identity":
        return DenseWire(value_dtype=value_dtype)
    raise ValueError(f"unknown compressor {compressor!r}; the port carries "
                     f"{WIRES}")


def coded_aggregate(wire: Wire, payloads: Payload, mask: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ghat = sum_i mask_i * C(acc_i) over the N coding ranks that share
    this device: the single-device form of the two-phase collective (see
    the module docstring for why it equals the chunked form bit for bit).
    payloads: the wire's payload leaves stacked over senders (N, ...);
    mask: (N,) f32."""
    wire.check(wire.payload_n(payloads))
    return wire.decode_reduce(payloads, mask, out=out)


def wire_for_compressor(comp, n: int, nd: int = 1) -> Wire:
    """The wire that carries a `core.compression` compressor on the coded
    collective (`n` the flat size, `nd` the chunk count): grouped and
    stochastic sign ride the sign wire, block top-K the sparse wire, the
    identity the f32 dense wire; global TopK and RandK ride the sparse
    wire with one block per chunk and a budget of ceil(k/nd) per chunk
    (RandK twice that)."""
    from .compression import (BlockTopK, GroupedSign, Identity, RandK,
                              StochasticSign, TopK)
    if isinstance(comp, (GroupedSign, StochasticSign)):
        return SignWire(group_size=comp.group_size if comp.group_size > 0
                        else n)
    if isinstance(comp, BlockTopK):
        return SparseWire(k_per_block=comp.k_per_block,
                          block_size=comp.block_size)
    if isinstance(comp, TopK):
        block = n // nd
        return SparseWire(k_per_block=min(block, math.ceil(comp.k / nd)),
                          block_size=block)
    if isinstance(comp, RandK):
        block = n // nd
        return SparseWire(k_per_block=min(block,
                                          2 * math.ceil(comp.k / nd)),
                          block_size=block)
    if isinstance(comp, Identity):
        return DenseWire()
    raise TypeError(f"no wire for compressor {type(comp).__name__}")


# ---------------------------------------------------------------------------
# phase 2 and the group form of the collective
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodingCollectiveConfig:
    """Phase 2 of the coded collective: the dtype of the broadcast of the
    aggregate (f32 is the paper's), or `phase2_sign` to re-pack it on the
    sign wire with `group_size` (a beyond-paper option of JAX's)."""

    group_size: int = 512
    phase2_dtype: str = "float32"
    phase2_sign: bool = False

    def __post_init__(self):
        ref.wire_dtype(self.phase2_dtype)


def _sign_unpack_into(out: torch.Tensor, words: torch.Tensor,
                      scales: torch.Tensor, group_size: int) -> None:
    """out (n,) <- sign(words) * scales, CHUNK // 4 coordinates at a time
    (the plain unpack makes an int64 per coordinate)."""
    step = max(group_size, CHUNK // 4)
    for i in range(0, out.numel(), step):
        m = min(step, out.numel() - i)
        out[i:i + m].copy_(ref.sign_unpack_ref(
            words[i // 32:(i + m) // 32],
            scales[i // group_size:(i + m) // group_size], group_size))


def phase2_local_(ghat: torch.Tensor, cfg: CodingCollectiveConfig,
                  rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Phase 2 where every coding rank shares the device: what the
    receivers of the all_gather get back, in place in ghat.  f32: nothing;
    bf16: ghat rounded through bf16, CHUNK at a time; phase2_sign:
    `SignWire(group_size).fused_pack` (the sign_pack kernel on the card),
    into `rows` = (words (n/32,), scales (n/g,)) when given, then unpacked.
    Chunks are whole groups, so packing the whole vector equals packing
    each chunk."""
    if cfg.phase2_sign:
        n, g = ghat.numel(), cfg.group_size
        if rows is None:
            rows = (torch.empty(n // 32, dtype=torch.uint32,
                                device=ghat.device),
                    torch.empty(n // g, dtype=torch.float32,
                                device=ghat.device))
        words, scales = SignWire(group_size=g).fused_pack(ghat, out=rows)
        _sign_unpack_into(ghat, words, scales, g)
    elif cfg.phase2_dtype != "float32":
        DenseWire(value_dtype=cfg.phase2_dtype).roundtrip_(ghat)
    return ghat


class _Done:
    def wait(self) -> None:
        pass


@dataclasses.dataclass
class DryGroup:
    """A process group of `size` ranks that records its collectives in
    `calls` ({"op", "result_bytes", "group", "phase"}) and moves nothing.
    Several DryGroups of one grid may share one `calls` list."""

    size: int
    phase: str
    calls: List = dataclasses.field(default_factory=list)

    def record(self, op: str, result: torch.Tensor) -> _Done:
        self.calls.append({"op": op, "phase": self.phase,
                           "result_bytes": result.numel()
                           * result.element_size(), "group": self.size})
        return _Done()


def _all_to_all(dst: torch.Tensor, src: torch.Tensor, group):
    """Async all_to_all of byte rows (a DryGroup records it)."""
    if isinstance(group, DryGroup):
        return group.record("all-to-all", dst)
    return dist.all_to_all_single(dst, src, group=group, async_op=True)


def _u8(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, (rows, bytes per row)."""
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def _gather(dst: torch.Tensor, src: torch.Tensor, group) -> None:
    """dst (k, *src.shape) <- every group member's src, in group order, as
    bytes (a DryGroup records it)."""
    if isinstance(group, DryGroup):
        group.record("all-gather", dst)
        return
    dist.all_gather([r.view(torch.uint8) for r in _u8(dst)],
                    src.reshape(-1).view(torch.uint8), group=group)


def _outer_sum(chunk_sum: torch.Tensor, grid) -> torch.Tensor:
    """The chunk sums of the outer group added in rank order from +0 (the
    outer psum of JAX's collective)."""
    if grid.outer_group is None:
        return chunk_sum
    parts = torch.empty((grid.n_outer,) + tuple(chunk_sum.shape),
                        dtype=chunk_sum.dtype, device=chunk_sum.device)
    _gather(parts, chunk_sum, grid.outer_group)
    acc = torch.zeros_like(chunk_sum)
    for o in range(grid.n_outer):
        acc = acc + parts[o]
    return acc


def _phase2_gather(chunk_sum: torch.Tensor, cfg: CodingCollectiveConfig,
                   grid, out: Optional[torch.Tensor]) -> torch.Tensor:
    """Phase 2: every chunk's sum back to every rank of the chunk group,
    in chunk order, into out (nd * n_c,) f32."""
    nd, n_c = grid.nd, chunk_sum.numel()
    if out is None:
        out = torch.empty(nd * n_c, dtype=torch.float32,
                          device=chunk_sum.device)
    if cfg.phase2_sign:
        g = cfg.group_size
        words, scales = SignWire(group_size=g).fused_pack(chunk_sum)
        all_w = torch.empty((nd,) + tuple(words.shape), dtype=words.dtype,
                            device=words.device)
        all_s = torch.empty((nd,) + tuple(scales.shape), dtype=scales.dtype,
                            device=scales.device)
        _gather(all_w, words, grid.chunk_group)
        _gather(all_s, scales, grid.chunk_group)
        _sign_unpack_into(out, all_w.reshape(-1), all_s.reshape(-1), g)
    elif cfg.phase2_dtype == "float32":
        _gather(out.view(nd, n_c), chunk_sum, grid.chunk_group)
    else:
        vdt = ref.wire_dtype(cfg.phase2_dtype)
        buf = torch.empty((nd, n_c), dtype=vdt, device=chunk_sum.device)
        _gather(buf, chunk_sum.to(vdt), grid.chunk_group)
        out.copy_(buf.reshape(-1))
    return out


@dataclasses.dataclass
class InFlightAggregate:
    """Phase 1 of a coded allreduce whose all_to_alls are issued and whose
    decode and phase 2 are not: `works` are the async handles of the
    all_to_alls, `recv` the typed views of their receive buffers (row i:
    sender i's chunk for this rank).  Finishing later changes no value
    (the pipelined bucket schedule of `core.cocoef`)."""

    recv: Payload
    works: List
    sender_mask: torch.Tensor
    wire: Wire
    cfg: CodingCollectiveConfig
    grid: object

    def finish(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Wait, decode + mask + sum the received chunks over their
        senders, sum across the outer group, run phase 2; returns the (n,)
        aggregate (written into `out` when given), the same bits on every
        coding rank."""
        for w in self.works:
            w.wait()
        chunk_sum = self.wire.decode_reduce(self.recv, self.sender_mask)
        return _phase2_gather(_outer_sum(chunk_sum, self.grid), self.cfg,
                              self.grid, out)


def coded_allreduce_start(wire: Wire, cfg: CodingCollectiveConfig, grid,
                          mask: torch.Tensor, payload: Payload,
                          recv: Optional[Payload] = None
                          ) -> InFlightAggregate:
    """Issue phase 1: one async `all_to_all_single` per payload leaf on the
    grid's chunk group, chunk j of every leaf to chunk rank j.  payload:
    this rank's leaves (contiguous, leading dim proportional to n); recv:
    receive buffers of the same shapes and dtypes (made when None).  mask:
    (N,) f32 over the whole grid in row-major order."""
    nd = grid.nd
    wire.check(wire.payload_n(payload), nd)
    if recv is None:
        recv = tuple(torch.empty_like(p) for p in payload)
    works, typed = [], []
    for p, r in zip(payload, recv):
        if not (p.is_contiguous() and r.is_contiguous()):
            raise ValueError("payload and receive buffers must be "
                             "contiguous")
        works.append(_all_to_all(_u8(r.reshape(nd, -1)),
                                 _u8(p.reshape(nd, -1)), grid.chunk_group))
        typed.append(r.reshape((nd, p.shape[0] // nd) + tuple(p.shape[1:])))
    base = grid.outer_index * nd
    return InFlightAggregate(tuple(typed), works, mask[base:base + nd],
                             wire, cfg, grid)


def two_phase_coded_allreduce(c_local: Optional[torch.Tensor], wire: Wire,
                              cfg: CodingCollectiveConfig, grid,
                              mask: torch.Tensor,
                              payload: Optional[Payload] = None,
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """sum_i mask_i * C(acc_i) across the grid's coding ranks with phase 1
    in `wire`'s packed format: `coded_allreduce_start(...).finish(out)`.
    c_local: this rank's C(acc_i), packed here when `payload` is None."""
    if payload is None:
        if c_local is None:
            raise ValueError("need c_local or a packed payload")
        payload = wire.pack(c_local)
    return coded_allreduce_start(wire, cfg, grid, mask, payload).finish(out)


def dense_allreduce(c_local: torch.Tensor, grid, mask: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SGC baseline's sum of mask_i * c_i over the grid, in JAX's order
    (a psum per coding axis, outer first): this rank's masked vector summed
    across the outer group in rank order from +0, then the two-phase path
    on `DenseWire(float32)` over the chunk group with every sender's mask
    1 (the mask is already applied), phase 2 in f32."""
    x = _outer_sum(c_local * mask[grid.rank].to(c_local.dtype), grid)
    chunk_only = dataclasses.replace(grid, outer_group=None)   # summed
    return two_phase_coded_allreduce(None, DenseWire(),
                                     CodingCollectiveConfig(), chunk_only,
                                     torch.ones_like(mask), payload=(x,),
                                     out=out)
