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

On one device the coded collective is a single decode
----------------------------------------------------
The JAX collective spreads the coding ranks over a mesh axis of nd devices
and aggregates in three parts (`repro/core/collectives.py:613-657`):
an all_to_all that sends chunk j of every sender's payload to rank j, a
per-chunk `decode_reduce` over the senders, and an f32 all_gather of the
chunk sums.  Decode-reduce works coordinate by coordinate: out[x] depends
only on the senders' payload entries for x's group or block and the mask,
summed in sender order.  Chunks are whole groups and whole blocks (n is
padded to a multiple of nd * pad_multiple, and pad_multiple is
lcm(group_size, block_size) on the block top-K wire), so every chunk's
payload is a contiguous slice of the full one (words and scales; indices,
values and scales of whole blocks), and the all_gather concatenates the
chunk sums in chunk order without touching their bits.  With every coding
rank on one device the three parts together are therefore one
`decode_reduce` over the full payloads — bit for bit, on either wire.
`coded_aggregate` is that form.  The dense wire goes one step further:
the ranks run one after another, so each rank's m_i * C(acc_i) is added
into one f32 accumulator as soon as it is made (`DenseWire.fold_`), which
is the sender-order sum bit for bit without an (N, n) payload.  The
multi-process NCCL collective is a later step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.topk_pack import index_dtype

__all__ = ["SignWire", "SparseWire", "DenseWire", "WIRES", "build_wire",
           "wire_bytes_sign", "coded_aggregate"]

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
                   rank: Optional[int] = None) -> Payload:
        """pack(x) through the kernel, written into `out` = (words, scales)
        when given.  `rank` is ignored: the sign wire has no budgets."""
        return ops.sign_pack(x, self.group_size, out=out)

    def fused_local_step(self, g: torch.Tensor, e: torch.Tensor, gamma,
                         mask_self, want_c: bool = False,
                         out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]] = None,
                         rank: Optional[int] = None):
        """acc = gamma*g + e; payload = pack(acc); c = C(acc);
        e_new = mask_self ? acc - c : e, in one pass over g and e.
        `out` = (words, scales, e_new) buffers; e_new may alias e.  `rank`
        is ignored.  Returns (payload, c or None, e_new)."""
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
                   rank: Optional[int] = None) -> Payload:
        """pack(x) through the kernel, k_max slots, with rank `rank`'s
        budget applied (its values past k_i are +0; None: no budget),
        written into `out` = (idx, values, scales) when given."""
        return ops.topk_pack(x, self.k_max, self.block_size,
                             self.value_dtype, out=out,
                             k_send=self.k_send(rank))

    def fused_local_step(self, g: torch.Tensor, e: torch.Tensor, gamma,
                         mask_self, want_c: bool = False,
                         out: Optional[Tuple[torch.Tensor, ...]] = None,
                         rank: Optional[int] = None):
        """acc = gamma*g + e; payload = pack(acc) with rank `rank`'s
        budget; c = unpack(payload) (values rounded to the wire dtype,
        times scale); e_new = mask_self ? acc - c : e, in one pass over g
        and e: with a budget, JAX's budget branch
        (`repro/core/cocoef.py:308-318`).  `out` = (idx, values, scales,
        e_new) buffers; e_new may alias e.  Returns (payload, c or None,
        e_new)."""
        idx, val, scales, c, e_new = ops.ef_topk_fused(
            g, e, gamma, mask_self, self.k_max, self.block_size,
            self.value_dtype, want_c=want_c, out=out,
            k_send=self.k_send(rank))
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
    step runs the in-place methods: `fused_local_step_` (cocoef) or
    `roundtrip_` (coco), then `fold_` into the ghat accumulator; that is
    JAX's base `fused_local_step` (`repro/core/collectives.py:185-207`)
    and its sender-order `decode_reduce`, rank by rank."""

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

    def alignment(self) -> int:
        return 1

    def check(self, n: int, nd: int = 1) -> None:
        _check_flat(self, n, nd)

    def roundtrip_(self, x: torch.Tensor) -> torch.Tensor:
        """x <- C(x) = f32(vdt(x)) in place (nothing to do on f32)."""
        if self.vdt != torch.float32:
            for i in range(0, x.numel(), CHUNK):
                xc = x[i:i + CHUNK]
                xc.copy_(xc.to(self.vdt))
        return x

    def fused_local_step_(self, g: torch.Tensor, e: torch.Tensor, gamma,
                          mask_self) -> torch.Tensor:
        """The Algorithm-1 local step in place: g <- c = C(acc) with acc =
        gamma*g + e (two roundings), and e <- mask_self ? acc - c : e,
        chunk by chunk (a CHUNK of temporaries).  Returns g, now c."""
        ref.mul_add_(gamma, g, e)                           # g = acc
        keep = ref.as_f32(mask_self, g) > 0
        for i in range(0, g.numel(), CHUNK):
            acc, ei = g[i:i + CHUNK], e[i:i + CHUNK]
            c = self.unpack(self.pack(acc))
            torch.where(keep, acc - c, ei, out=ei)
            if c is not acc:
                acc.copy_(c)
        return g

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
