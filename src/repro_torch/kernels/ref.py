"""Plain PyTorch versions of the port's kernels (mirror of
`repro/kernels/ref.py`: the sign, the block top-K and the dense wires,
and flash attention).

They define the semantics: the CUDA kernels in `csrc/` must match them
bit for bit (the group sum follows the kernel's order), and the wrappers
in `sign_pack.py` and `topk_pack.py` run them for CPU tensors.  Sign words
are built in int64 and cast to uint32, because torch on the CPU has no
uint32 shift.

Block top-K selection is a stable descending sort of |x| per block, which
gives `lax.top_k`'s order (magnitude descending, first occurrence winning
ties); `torch.topk` orders ties otherwise (ROADMAP C1).  `block_topk_ref`
keeps that set too, as JAX's Pallas `block_topk` does, not the set of
JAX's `ref.block_topk_ref` (ROADMAP C8).  Signed zeros
follow JAX's jnp reference, not its Pallas kernel (ROADMAP C7): a selected
-0.0 keeps its sign in the values, in c and in e' = acc - c.

`flash_attention_ref` is the one plain version that its kernel matches
within a stated tolerance instead of bit for bit: the kernel walks each
row of scores tile by tile with an online softmax, so its sums run in
another order.
"""
from __future__ import annotations

from typing import Tuple

import torch

_F32 = torch.float32
CHUNK = 1 << 26      # elements a plain full-vector pass widens at a time


def as_f32(v, like: torch.Tensor) -> torch.Tensor:
    """v as an f32 tensor on like's device (a scalar such as gamma)."""
    return torch.as_tensor(v, dtype=_F32, device=like.device)


def mul_add(gamma, g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The Algorithm-1 accumulate  acc = gamma * g + e  as two separately
    rounded f32 ops (eager PyTorch never contracts them into an FMA), g
    and e f32 or bf16, widened first (JAX's `ref.mul_add`)."""
    return as_f32(gamma, g) * g.to(_F32) + e.to(_F32)


def mul_add_(gamma, g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """`mul_add` written into the f32 g (g <- gamma * g + e, the same two
    roundings; e f32 or bf16, widened in the add); returns g."""
    if g.dtype != _F32:
        raise TypeError(f"mul_add_ writes acc into g: need f32 g, got "
                        f"{g.dtype}")
    return g.mul_(as_f32(gamma, g)).add_(e)


def mul_add_into(acc: torch.Tensor, gamma, g: torch.Tensor,
                 e: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """`mul_add` written into the f32 `acc` (which may be g itself), a
    chunk of widened temporaries at a time; returns acc."""
    if acc.data_ptr() == g.data_ptr() and acc.dtype == g.dtype:
        return mul_add_(gamma, g, e)
    gam = as_f32(gamma, g)
    for i in range(0, acc.numel(), chunk):
        a = acc[i:i + chunk]
        torch.mul(g[i:i + chunk].to(_F32), gam, out=a)
        a.add_(e[i:i + chunk])
    return acc


def gamma_times_into(out: torch.Tensor, gamma, x: torch.Tensor,
                     chunk: int = CHUNK) -> torch.Tensor:
    """out (f32, may be x itself) <- gamma * x rounded once in f32, x f32
    or bf16, a chunk of widened temporaries at a time; returns out."""
    gam = as_f32(gamma, x)
    for i in range(0, out.numel(), chunk):
        torch.mul(x[i:i + chunk].to(_F32), gam, out=out[i:i + chunk])
    return out


def gamma_times(x: torch.Tensor, gamma) -> torch.Tensor:
    """f32 of x (f32 or bf16), times gamma when given, rounded once in
    f32: JAX's  gamma * g  on the widened gradient."""
    xf = x.to(_F32)
    return xf if gamma is None else as_f32(gamma, x) * xf


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


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in a fixed binary tree of rounded adds (zero
    padded to a power of two, then halved until one is left), in x's
    dtype: the same bits on the CPU and on the card, where torch's own
    reductions order their adds by device and shape."""
    width = 1 << max(0, (x.shape[-1] - 1).bit_length())
    if width != x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def sign_pack_ref(x: torch.Tensor, group_size: int, gamma=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) f32 or bf16 -> (words (n/32,) u32, scales (n/g,) f32 =
    mean |acc|) of acc = `gamma_times(x, gamma)`."""
    xf = gamma_times(x, gamma)
    return _pack_words(xf), group_abs_mean(xf, group_size)


def sign_unpack_ref(words: torch.Tensor, scales: torch.Tensor,
                    group_size: int) -> torch.Tensor:
    signs = _signs(words).reshape(-1, group_size)
    return (signs * scales.to(_F32)[:, None]).reshape(-1)


def ef_sign_fused_ref(g: torch.Tensor, e: torch.Tensor, gamma, mask_self,
                      group_size: int):
    """Fused Algorithm-1 local step (g and e f32 or bf16, widened):
      acc = gamma * g + e;  (words, scales) = sign_pack(acc)
      c = sign(acc) * scale;  e_new = mask_self > 0 ? acc - c : e
    e_new in e's dtype: the f32 value rounded once (JAX's cast to
    ef_dtype; a straggler's e comes back unchanged).
    Returns (words, scales, c, e_new)."""
    accg = mul_add(gamma, g, e).reshape(-1, group_size)
    scales = group_abs_mean(accg, group_size)
    words = _pack_words(accg)
    c = torch.where(accg >= 0, 1.0, -1.0) * scales[:, None]
    keep = as_f32(mask_self, g) > 0
    e_new = torch.where(keep, accg - c, e.to(_F32).reshape(-1, group_size))
    return words, scales, c.reshape(-1), e_new.reshape(-1).to(e.dtype)


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


def dense_decode_reduce_ref(values: torch.Tensor, mask: torch.Tensor
                            ) -> torch.Tensor:
    """sum_i mask_i * f32(values_i), over senders in order from +0.0, each
    product rounded on its own: JAX's `dense_decode_reduce_scan` (the
    dense wire has no kernel).  values (N, n) f32 or bf16, mask (N,) f32
    -> (n,) f32."""
    acc = torch.zeros(values.shape[1], dtype=_F32, device=values.device)
    for i in range(values.shape[0]):
        acc = acc + mask[i].to(_F32) * values[i].to(_F32)
    return acc


WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def wire_dtype(name: str) -> torch.dtype:
    """torch dtype of a wire value dtype given by its JAX name."""
    if name not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {name!r}; have "
                         f"{tuple(WIRE_DTYPES)}")
    return WIRE_DTYPES[name]


def topk_select(blocks: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """blocks (nb, B) f32 -> (idx (nb, k) int64, signed kept values (nb, k))
    of each block's k largest |x|, magnitude descending, first occurrence
    winning ties: `lax.top_k` on |x|, by a stable sort (ROADMAP C1)."""
    if not 0 < k <= blocks.shape[-1]:
        raise ValueError(f"need 0 < k <= block width, got {k} / "
                         f"{blocks.shape[-1]}")
    idx = torch.sort(blocks.abs(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    return idx, torch.gather(blocks, 1, idx)


def _safe_scale(sv: torch.Tensor) -> torch.Tensor:
    """Block max |x| (= |first kept value|), 1.0 for an all-zero block."""
    scale = sv[:, 0].abs()
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def _budget_(values: torch.Tensor, k_send) -> torch.Tensor:
    """+0 in the slots past the first k_send (None: all k), in place: a
    coding rank's budget (JAX's `SparseWire.apply_rank_budget`)."""
    if k_send is not None:
        values[:, k_send:] = 0.0
    return values


def topk_pack_ref(x: torch.Tensor, k: int, block_size: int, k_send=None,
                  gamma=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (n,) f32 or bf16, acc = `gamma_times(x, gamma)` -> (idx (n/B, k) i32,
    values (n/B, k) f32 = kept acc / scale, +0 past slot k_send (default
    k), scales (n/B,) f32 = block max |acc|, 1.0 for an all-zero
    block)."""
    blocks = gamma_times(x, gamma).reshape(-1, block_size)
    idx, sv = topk_select(blocks, k)
    safe = _safe_scale(sv)
    return idx.to(torch.int32), _budget_(sv / safe[:, None], k_send), safe


def _scatter_blocks(idx: torch.Tensor, sv: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Flat (nb*B,) f32: zeros, with sv (nb, k) at the in-block positions
    idx (nb, k)."""
    nb = idx.shape[0]
    base = torch.arange(nb, dtype=torch.int64, device=idx.device)[:, None]
    flat = (base * block_size + idx.to(torch.int64)).reshape(-1)
    out = torch.zeros(nb * block_size, dtype=_F32, device=idx.device)
    return out.index_put_((flat,), sv.reshape(-1))


def ef_topk_fused_ref(g: torch.Tensor, e: torch.Tensor, gamma, mask_self,
                      k: int, block_size: int,
                      value_dtype="float32", k_send=None):
    """Fused Algorithm-1 local step on the block top-K wire:
      acc = gamma * g + e;  (idx, sv) = top-k of |acc| per block
      scale = block max |acc| (1.0 if 0);  val = value_dtype(sv / scale),
      +0 past slot k_send (default k: none)
      c = scatter(val * scale);  e_new = mask_self > 0 ? acc - c : e
    With k_send this is JAX's per-rank budget branch
    (`repro/core/cocoef.py:308-318`): c is the unpacked budgeted payload,
    +0 at the positions of the zeroed slots, where e_new = acc.
    g and e are f32 or bf16 (widened); e_new is in e's dtype, the f32
    value rounded once.
    Returns (idx i32, val f32 holding value_dtype-rounded numbers, scale,
    c, e_new).  A selected -0.0 stays -0.0 in val and c (ROADMAP C7)."""
    accb = mul_add(gamma, g, e).reshape(-1, block_size)
    idx, sv = topk_select(accb, k)
    safe = _safe_scale(sv)
    val = _budget_((sv / safe[:, None]).to(wire_dtype(value_dtype))
                   .to(_F32), k_send)
    c = _scatter_blocks(idx, val * safe[:, None], block_size)
    keep = as_f32(mask_self, g) > 0
    e_new = torch.where(keep, accb.reshape(-1) - c, e.to(_F32))
    return idx.to(torch.int32), val, safe, c, e_new.to(e.dtype)


def topk_unpack_ref(idx: torch.Tensor, values: torch.Tensor,
                    scales: torch.Tensor, block_size: int) -> torch.Tensor:
    """Inverse of topk_pack_ref: the kept values * scale scattered back,
    flat (n,) f32."""
    sv = values.to(_F32) * scales.to(_F32)[:, None]
    return _scatter_blocks(idx, sv, block_size)


def topk_decode_reduce_ref(idx: torch.Tensor, values: torch.Tensor,
                           scales: torch.Tensor, mask: torch.Tensor,
                           block_size: int) -> torch.Tensor:
    """sum_i mask_i * unpack(payload_i), over senders in order from +0.0,
    each product rounded on its own (sv = val*scale, then mask*sv, then
    the add): JAX's `topk_decode_reduce_scan`.  idx, values (N, n/B, k),
    scales (N, n/B), mask (N,) f32 -> (n,) f32."""
    acc = torch.zeros(idx.shape[1] * block_size, dtype=_F32,
                      device=idx.device)
    for i in range(idx.shape[0]):
        acc = acc + mask[i].to(_F32) * topk_unpack_ref(idx[i], values[i],
                                                       scales[i], block_size)
    return acc


def block_topk_ref(x: torch.Tensor, k: int, block_size: int) -> torch.Tensor:
    """Block top-k sparsification: x (n,) -> (n,) of x's dtype keeping each
    block's k largest |x| (`topk_select` on the f32 of x) with their bits,
    so a kept -0.0 stays -0.0, and +0.0 elsewhere, as JAX's Pallas
    `block_topk` (`jnp.where(keep, x, 0.0)`).

    ROADMAP C8: JAX's `ref.block_topk_ref` and `BlockTopK.apply` keep the
    first k entries with |x| >= the k-th largest, so ties at that value
    which come before a larger entry push the larger one out: on a block
    |x| = [3, 3, 5, ...] with k = 2 they keep positions {0, 1}, where
    `lax.top_k`, the Pallas kernel and this function keep {0, 2}."""
    blocks = x.reshape(-1, block_size)
    idx, _ = topk_select(blocks.to(_F32), k)
    out = torch.zeros_like(blocks)
    return out.scatter_(1, idx, torch.gather(blocks, 1, idx)
                        ).reshape(x.shape)


NEG_INF = -1e30          # JAX's masked score (not -inf)
BIG_WINDOW = 1 << 30     # "no window"
REF_ROWS = 4096          # flash_attention_ref's query rows at a time


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        softcap: float = 0.0, window: int = 0,
                        groups: int = 1) -> torch.Tensor:
    """Causal (+ sliding window, + tanh softcap) GQA attention, as JAX's
    `ref.flash_attention_ref`: q (B, H, S, hd) pre-scaled, k, v
    (B, H / groups, S, hd), query head h reading kv head h // groups.
    Scores in f32 from the widened inputs: each q.k summed in f64 and
    rounded once, so a score is its exact value to half an f32 ulp, as
    the f32 kernel computes it.  An f32 product's own order can be much
    worse: on an H100, cuBLAS sums the hd = 288 terms in one chain at
    S = 4096, which put this function up to 1.24 times the kernel's
    tolerance off the float64 answer and the kernel 0.24
    (`tools/flash_check.py --conditioning`): too far off to hold a kernel
    to.  Then softcap * tanh(s / softcap), masked to -1e30, softmax in
    f32, p.v in f32, cast to q's dtype.  Runs one (batch, kv head) at a
    time, and REF_ROWS query rows at a time, so only that group's
    (groups, REF_ROWS, S) scores are ever live (each row's numbers are
    its own; a 32768-long prompt's f64 scores of a group of 4 heads would
    take 34 GB at once)."""
    B, H, S, hd = q.shape
    w = window if window > 0 else BIG_WINDOW
    pos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    for b in range(B):
        for hk in range(H // groups):
            hs = slice(hk * groups, (hk + 1) * groups)
            kd, vf = k[b, hk].double(), v[b, hk].to(_F32)
            for r0 in range(0, S, REF_ROWS):
                qp = pos[r0:r0 + REF_ROWS, None]
                keep = (pos[None, :] <= qp) & (pos[None, :] > qp - w)
                s = (q[b, hs, r0:r0 + REF_ROWS].double() @ kd.T).to(_F32)
                if softcap > 0:
                    s = softcap * torch.tanh(s / softcap)
                s = torch.where(keep, s, NEG_INF)
                p = torch.softmax(s, dim=-1)
                out[b, hs, r0:r0 + REF_ROWS] = (p @ vf).to(q.dtype)
    return out
