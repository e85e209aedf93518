"""Plain PyTorch versions of the port's kernels (mirror of
`repro/kernels/ref.py`, sign wire only).

They define the semantics: the CUDA kernels in `csrc/` must match them
bit for bit (the group sum follows the kernel's order), and the wrappers
in `sign_pack.py` run them for CPU tensors.  Sign words are built in int64
and cast to uint32, because torch on the CPU has no uint32 shift.
"""
from __future__ import annotations

from typing import Tuple

import torch

_F32 = torch.float32


def _as_f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32, device=like.device)


def mul_add(gamma, g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The Algorithm-1 accumulate  acc = gamma * g + e  as two separately
    rounded f32 ops (eager PyTorch never contracts them into an FMA)."""
    return _as_f32(gamma, g) * g.to(_F32) + e.to(_F32)


def _pack_words(x: torch.Tensor) -> torch.Tensor:
    """bit j of word w = x[32w+j] >= 0 (so -0.0 packs as +) -> (n/32,) u32."""
    bits = (x >= 0).reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return (bits << shifts).sum(-1).to(torch.uint32)


def _signs(words: torch.Tensor) -> torch.Tensor:
    """(n/32,) u32 words -> (n,) f32 of +1/-1."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[:, None] >> shifts) & 1
    return bits.to(_F32).reshape(-1) * 2.0 - 1.0


def group_abs_mean(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """mean |x| per group of `group_size`, (n/g,), summed in the fixed order
    of the CUDA kernel: lane j < 32 adds elements j, j+32, j+64, ... of the
    group in turn, then the 32 lane sums meet in an xor butterfly (each
    lane adds the lane `off` away, off = 16, 8, 4, 2, 1), then one division
    by g.  So kernel and plain version agree bit for bit.  XLA's order is
    another one and cannot be reproduced (ROADMAP C3)."""
    t = x.abs().reshape(-1, group_size // 32, 32)
    p = t[:, 0]
    for w in range(1, group_size // 32):
        p = p + t[:, w]
    lanes = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        p = p + p[:, lanes ^ off]
    return p[:, 0] / group_size


def sign_pack_ref(x: torch.Tensor, group_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) f32 -> (words (n/32,) u32, scales (n/g,) f32 = mean |x|)."""
    xf = x.to(_F32)
    return _pack_words(xf), group_abs_mean(xf, group_size)


def sign_unpack_ref(words: torch.Tensor, scales: torch.Tensor,
                    group_size: int) -> torch.Tensor:
    signs = _signs(words).reshape(-1, group_size)
    return (signs * scales.to(_F32)[:, None]).reshape(-1)


def ef_sign_fused_ref(g: torch.Tensor, e: torch.Tensor, gamma, mask_self,
                      group_size: int):
    """Fused Algorithm-1 local step:
      acc = gamma * g + e;  (words, scales) = sign_pack(acc)
      c = sign(acc) * scale;  e_new = mask_self > 0 ? acc - c : e
    Returns (words, scales, c, e_new)."""
    accg = mul_add(gamma, g, e).reshape(-1, group_size)
    scales = group_abs_mean(accg, group_size)
    words = _pack_words(accg)
    c = torch.where(accg >= 0, 1.0, -1.0) * scales[:, None]
    keep = _as_f32(mask_self, g) > 0
    e_new = torch.where(keep, accg - c, e.to(_F32).reshape(-1, group_size))
    return words, scales, c.reshape(-1), e_new.reshape(-1)


def sign_decode_reduce_ref(words: torch.Tensor, scales: torch.Tensor,
                           mask: torch.Tensor, group_size: int
                           ) -> torch.Tensor:
    """sum_i mask_i * unpack(words_i, scales_i), taken over senders in
    order from +0.0 — the sender-order sum every implementation shares.
    words (N, n/32) u32, scales (N, n/g) f32, mask (N,) f32 -> (n,) f32."""
    n = words.shape[1] * 32
    acc = torch.zeros(n, dtype=_F32, device=words.device)
    for i in range(words.shape[0]):
        acc = acc + mask[i].to(_F32) * sign_unpack_ref(words[i], scales[i],
                                                       group_size)
    return acc
