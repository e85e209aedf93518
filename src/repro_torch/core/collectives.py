"""The sign wire and the coded aggregate of COCO-EF (port of the sign-wire
part of `repro.core.collectives`).

SignWire is the wire contract: `pack`/`unpack` are the plain semantics,
`fused_local_step` and `decode_reduce` route through the kernels
(`repro_torch.kernels.ops`: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors).

On one device the coded collective is a single decode
----------------------------------------------------
The JAX collective spreads the coding ranks over a mesh axis of nd devices
and aggregates in three parts (`repro/core/collectives.py:613-657`):
an all_to_all that sends chunk j of every sender's payload to rank j, a
per-chunk `decode_reduce` over the senders, and an f32 all_gather of the
chunk sums.  Decode-reduce works coordinate by coordinate: out[x] depends
only on the senders' bit for x, their scale for x's group and the mask,
summed in sender order.  Chunks are whole groups (n is padded to a
multiple of nd * group_size), so every chunk's words and scales are a
contiguous slice of the full ones, and the all_gather concatenates the
chunk sums in chunk order without touching their bits.  With every coding
rank on one device the three parts together are therefore one
`sign_decode_reduce` over the full payloads — bit for bit.  `coded_aggregate`
is that form.  The multi-process NCCL collective is a later step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops, ref

__all__ = ["SignWire", "wire_bytes_sign", "coded_aggregate"]


def wire_bytes_sign(n: int, group_size: int) -> int:
    """Bytes on the wire for one rank's phase-1 payload."""
    return n // 8 + 4 * (n // group_size)


Payload = Tuple[torch.Tensor, torch.Tensor]      # (words u32, scales f32)


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
        a = self.alignment()
        if n <= 0 or n % (nd * a):
            raise ValueError(
                f"SignWire: flat size {n} must be a positive multiple of "
                f"chunk_count*alignment = {nd}*{a}; pad upstream")

    def payload_n(self, payload: Payload) -> int:
        return payload[0].shape[-1] * 32

    def fused_local_step(self, g: torch.Tensor, e: torch.Tensor, gamma,
                         mask_self, want_c: bool = False,
                         out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]] = None):
        """acc = gamma*g + e; payload = pack(acc); c = C(acc);
        e_new = mask_self ? acc - c : e, in one pass over g and e.
        `out` = (words, scales, e_new) buffers; e_new may alias e.
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


def coded_aggregate(wire: SignWire, payloads: Payload, mask: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ghat = sum_i mask_i * C(acc_i) over the N coding ranks that share
    this device: the single-device form of the two-phase collective (see
    the module docstring for why it equals the chunked form bit for bit).
    payloads: (words (N, n/32), scales (N, n/g)); mask: (N,) f32."""
    wire.check(wire.payload_n(payloads))
    return wire.decode_reduce(payloads, mask, out=out)
