"""Compressors of COCO-EF and its baselines (port of
`repro.core.compression`) for the (N, D) reference loop.

The paper's biased compressors (Sec. III), grouped sign and top-K (global
and block-local), the unbiased ones of the baselines (Sec. V), stochastic
sign and amplified rand-K, the identity, and `WireCompressor`, which turns
a wire of `core.collectives` into the compressor its receivers decode.

Every compressor is a frozen dataclass with
  apply(x, key=None) -> C(x)   same shape and dtype as x, plain PyTorch on
                               x's device (either device, the same bits)
  wire_bits(n)                 bits on the wire for an n-element input
  delta(n)                     the contraction constant of Assumption 5
                               (biased compressors only)

Keys are `core/prng.py` keys; StochasticSign and RandK draw JAX's bits
from them.  Where JAX's result depends on XLA's order the port states its
own:
  - GroupedSign's group mean |x| is summed in the kernels' order
    (`kernels.ref.group_abs_mean`) where the group is a multiple of 32, so
    it equals SignWire's roundtrip bit for bit; otherwise torch's mean.
    XLA's order cannot be reproduced (ROADMAP C3).
  - TopK keeps `lax.top_k`'s set: magnitude descending, the first
    occurrence winning ties (a stable sort, ROADMAP C1).
  - BlockTopK keeps JAX's `BlockTopK.apply` set: the first k entries of a
    block with |x| >= its k-th largest |x| (ROADMAP C8), not the set of
    the Pallas `block_topk` that `kernels.ops.block_topk` follows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import ref

__all__ = ["Compressor", "GroupedSign", "TopK", "BlockTopK",
           "StochasticSign", "RandK", "Identity", "WireCompressor",
           "get_compressor"]


def _strict_sign(x: torch.Tensor) -> torch.Tensor:
    """sign with sign(+-0) := +1, so the output is 1-bit representable."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class; `unbiased` is True where E[C(x)] = x."""

    unbiased: bool = dataclasses.field(default=False, init=False)

    def apply(self, x: torch.Tensor, key: Optional[np.ndarray] = None
              ) -> torch.Tensor:
        raise NotImplementedError

    def wire_bits(self, n: int) -> int:
        raise NotImplementedError

    def delta(self, n: int) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """No compression (the delta = 0 bound of Sec. IV)."""

    def apply(self, x, key=None):
        return x

    def wire_bits(self, n):
        return 32 * n

    def delta(self, n):
        return 0.0


@dataclasses.dataclass(frozen=True)
class GroupedSign(Compressor):
    """Grouped sign quantization, eq. (5)-(6): sign(x) * mean |x| per group;
    group_size <= 0 is one group over the whole vector.  delta = 1 - 1/g
    (Prop. 2)."""

    group_size: int = -1

    def _groups(self, n: int) -> int:
        g = n if self.group_size <= 0 else self.group_size
        if n % g != 0:
            raise ValueError(f"group_size {g} must divide n={n}; pad upstream")
        return g

    def apply(self, x, key=None):
        flat = x.reshape(-1)
        g = self._groups(flat.shape[0])
        grouped = flat.reshape(-1, g)
        if g % 32 == 0:
            scale = ref.group_abs_mean(grouped.reshape(-1), g)[:, None]
        else:
            scale = grouped.abs().mean(-1, keepdim=True)
        return (_strict_sign(grouped) * scale).reshape(x.shape).to(x.dtype)

    def wire_bits(self, n):
        g = self._groups(n)
        return n + 32 * (n // g)

    def delta(self, n):
        return 1.0 - 1.0 / self._groups(n)


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Exact global top-K magnitude sparsification.  delta = 1 - K/D."""

    k: int = 1

    def apply(self, x, key=None):
        flat = x.reshape(-1)
        k = min(self.k, flat.shape[0])
        idx, _ = ref.topk_select(flat.to(torch.float32)[None], k)
        keep = torch.zeros(flat.shape[0], dtype=torch.bool, device=x.device)
        keep[idx[0]] = True
        return torch.where(keep, flat, 0.0).reshape(x.shape).to(x.dtype)

    def wire_bits(self, n):
        return min(self.k, n) * (32 + 32)

    def delta(self, n):
        return 1.0 - min(self.k, n) / n


@dataclasses.dataclass(frozen=True)
class BlockTopK(Compressor):
    """Top-`k_per_block` within each contiguous block of `block_size`;
    delta = 1 - k/B.  Keeps JAX's tie set (module docstring)."""

    k_per_block: int = 8
    block_size: int = 256

    def apply(self, x, key=None):
        flat = x.reshape(-1)
        b = self.block_size
        if flat.shape[0] % b != 0:
            raise ValueError(f"block_size {b} must divide n="
                             f"{flat.shape[0]}; pad upstream")
        blocks = flat.reshape(-1, b)
        k = min(self.k_per_block, b)
        mag = blocks.abs()
        thr = torch.sort(mag, dim=-1, descending=True).values[:, k - 1:k]
        keep = mag >= thr
        keep &= torch.cumsum(keep.to(torch.int32), dim=-1) <= k
        return torch.where(keep, blocks, 0.0).reshape(x.shape).to(x.dtype)

    def wire_bits(self, n):
        k = min(self.k_per_block, self.block_size)
        return (n // self.block_size) * k * (32 + 16)

    def delta(self, n):
        return 1.0 - min(self.k_per_block, self.block_size) / self.block_size


@dataclasses.dataclass(frozen=True)
class StochasticSign(Compressor):
    """Unbiased stochastic 1-bit quantization per group (the baseline of
    [32]): with m = max |x| of the group, Q_j = m * (2 B_j - 1),
    B_j ~ Bern((1 + x_j / m) / 2); all-zero groups stay zero.  The
    uniforms are `jax.random.uniform(key, (n/g, g))`'s."""

    group_size: int = -1
    unbiased: bool = dataclasses.field(default=True, init=False)

    def apply(self, x, key=None):
        if key is None:
            raise ValueError("StochasticSign requires a PRNG key")
        flat = x.reshape(-1).to(torch.float32)
        g = flat.shape[0] if self.group_size <= 0 else self.group_size
        grouped = flat.reshape(-1, g)
        mx = grouped.abs().amax(-1, keepdim=True)
        m = torch.where(mx == 0, 1.0, mx)
        p_up = 0.5 * (1.0 + grouped / m)
        u = torch.from_numpy(prng.uniform(key, tuple(grouped.shape))
                             ).to(x.device)
        out = torch.where(u < p_up, m, -m)
        out = torch.where(mx == 0, 0.0, out)
        return out.reshape(x.shape).to(x.dtype)

    def wire_bits(self, n):
        g = n if self.group_size <= 0 else self.group_size
        return n + 32 * (n // g)


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Amplified rand-K sparsification [14]: K coordinates drawn without
    replacement (`jax.random.choice`'s), times D/K."""

    k: int = 1
    unbiased: bool = dataclasses.field(default=True, init=False)

    def apply(self, x, key=None):
        if key is None:
            raise ValueError("RandK requires a PRNG key")
        flat = x.reshape(-1)
        n = flat.shape[0]
        k = min(self.k, n)
        idx = torch.from_numpy(prng.choice(key, n, (k,)).astype(np.int64))
        keep = torch.zeros(n, dtype=torch.bool)
        keep[idx] = True
        scaled = flat * torch.tensor(n / k, dtype=flat.dtype,
                                     device=x.device)
        return torch.where(keep.to(x.device), scaled, 0.0
                           ).reshape(x.shape).to(x.dtype)

    def wire_bits(self, n):
        return min(self.k, n) * (32 + 32)


@dataclasses.dataclass(frozen=True)
class WireCompressor(Compressor):
    """A wire of `core.collectives` as a reference-loop compressor: `apply`
    is the wire's roundtrip unpack(pack(x)), what the coded collective's
    receivers reconstruct, bit for bit.  The reference loop run with it and
    the coded step on the same wire give the same trajectory
    (`launch.parity`)."""

    wire: object

    def apply(self, x, key=None):
        flat = x.reshape(-1)
        return (self.wire.unpack(self.wire.pack(flat))
                .reshape(x.shape).to(x.dtype))

    def wire_bits(self, n):
        return 8 * int(self.wire.wire_bytes(n))


_REGISTRY = {
    "identity": Identity,
    "sign": GroupedSign,
    "grouped_sign": GroupedSign,
    "topk": TopK,
    "block_topk": BlockTopK,
    "stochastic_sign": StochasticSign,
    "randk": RandK,
}


def get_compressor(name: str, **kwargs) -> Compressor:
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
