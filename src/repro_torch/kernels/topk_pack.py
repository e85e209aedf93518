"""Wrappers of the block top-K wire CUDA kernels and the `block_topk`
sparsifier (`csrc/topk_pack.cu`).

For a CUDA tensor a wrapper launches its hand-written Hopper kernel on the
current stream, or raises: there is no fallback.  Only for CPU tensors does
it run the plain version in `ref.py`, which takes any block size and k that
JAX's reference takes.  The kernels take B in SUPPORTED_BLOCK_SIZES
(`block_topk` in BLOCK_TOPK_SIZES), 1 <= k <= K_MAX and f32 or bf16 values;
anything else raises ValueError on CUDA.  `ef_topk_fused` has an instance
for each (g dtype, e dtype) in DTYPES^2 and `topk_pack` one for each x
dtype in DTYPES (f32, bf16); a CUDA tensor of another dtype raises
TypeError.  Payloads are in the wire's
dtypes: in-block indices u16 (u32 when B > 65536), values in the value
dtype, scales f32.  Each kernel launch adds
one to `launches[<name>]` and charges its bytes and operations
(`cost.py`) to the active op counters (`common.charge`).  On the meta
device (the dry run's) a wrapper checks its arguments as for the card,
returns outputs of the kernel's shapes and dtypes and charges the
counters in place of the launch, which it does not make; the global
route runs there as on the card, its B6 launches charged the same way.

The global route
----------------
Global top-K (compressor "topk") is one block per all_to_all chunk: B =
n / nd, 665,057,280 on the train slice.  For a B larger than any kernel
block (`is_global`), `ef_topk_fused`, `topk_pack` and `topk_decode_reduce`
take the global route on CUDA, which computes the plain versions at that B
exactly (the stable-sort selection, `lax.top_k`'s order):

  select  `topk_pack`'s kernel (B6) on blocks of ROUND_BLOCK keeps each
          block's top k; the kept entries' exact values are gathered, in
          (block, slot) order, and B6 runs again on them, until a chunk has
          at most FINAL_SORT candidates, which one stable sort orders.  An
          entry of the chunk's top k under (|x| desc, position asc) has
          fewer than k predecessors in its own block, so it is in that
          block's top k; and (block, slot) order is position order among
          equal magnitudes, so every round sees the chunk's own order.
          Each chunk's candidates are padded with +0 at their end, which
          sorts after every real entry.  B6 runs at least once, so no
          chunk is ever sorted whole.
  pack    scale = the first kept |x| (1.0 if 0), values = vdt(x / scale).
  e'      (ef_topk_fused) acc = gamma*g + e is written into `acc`, an f32
          buffer of n (by default g itself, which must then be f32; the
          step passes its ghat buffer, free until the decode); e' = mask ?
          acc : e everywhere (acc - (+0) is
          acc, -0.0 included), then mask ? acc - c : e at the nd * k kept
          positions.
  decode  a zeroed output, and the sender-order sum at the union of the
          N * nd * k kept positions (a sender that did not keep a position
          adds mask * +0 there, as JAX's scan does).

The glue between the B6 launches is plain PyTorch, as JAX's is jnp (its
global route is `lax.top_k`, no Pallas kernel); B6's launches count under
"topk_pack".  On the CPU the wrappers run the plain versions (and leave
acc in `acc` on the global route, as the card does); the `*_global` functions
run the route itself on either device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build, cost, ref
from .common import (LL, VP, I, charge, check, check_dtype, dtype_code,
                     launches, raise_if, scalar, stream)

SUPPORTED_BLOCK_SIZES = (64, 128, 256, 512)   # see TOPK_DISPATCH
BLOCK_TOPK_SIZES = (128, 256, 512)     # see block_topk_launch
K_MAX = 32                             # one output slot per lane
DECODE_TILE = 8192         # topk_decode_reduce's tile: kDecTile in csrc
ROUND_BLOCK = 256          # B6's block in the global route's rounds
FINAL_SORT = 1024          # a chunk's candidates are sorted at this many


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("topk_pack")
    lib.ef_topk_fused_launch.argtypes = [VP] * 9 + [LL, I, I, I, I, I, VP]
    lib.ef_topk_fused_launch.restype = I
    lib.topk_pack_launch.argtypes = [VP] * 5 + [LL, I, I, I, I, I, VP]
    lib.topk_pack_launch.restype = I
    lib.topk_decode_reduce_launch.argtypes = [VP] * 5 + [I, LL, I, I, I, VP]
    lib.topk_decode_reduce_launch.restype = I
    lib.block_topk_launch.argtypes = [VP] * 2 + [LL, I, I, I, VP]
    lib.block_topk_launch.restype = I
    return lib


def index_dtype(block_size: int) -> torch.dtype:
    """The wire's in-block index dtype (as `SparseWire.index_dtype`)."""
    return torch.uint16 if block_size <= (1 << 16) else torch.uint32


def is_global(block_size: int) -> bool:
    """Whether the wrappers take the global route for this block size on
    CUDA: blocks larger than any kernel block (global top-K's n / nd)."""
    return block_size > max(SUPPORTED_BLOCK_SIZES)


def _check_shape(n: int, k: int, block_size: int, vdt: torch.dtype,
                 device: torch.device,
                 sizes: Tuple[int, ...] = SUPPORTED_BLOCK_SIZES,
                 global_route: bool = False) -> None:
    if block_size <= 0 or n <= 0 or n % block_size:
        raise ValueError(f"need n a positive multiple of block_size (n={n}, "
                         f"B={block_size})")
    if not 0 < k <= block_size:
        raise ValueError(f"need 0 < k <= block_size, got {k} / {block_size}")
    if device.type in ("cuda", "meta"):
        if block_size not in sizes and not (global_route and
                                            is_global(block_size)):
            raise ValueError(f"no CUDA kernel for block_size={block_size}; "
                             f"have {sizes}")
        if k > K_MAX:
            raise ValueError(f"no CUDA kernel for k={k}; have 1..{K_MAX}")
        if vdt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"no CUDA kernel for values of {vdt}")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")


def _k_send(k_send: Optional[int], k: int) -> int:
    """The budget k_send (default k): how many of the k slots carry a
    value."""
    if k_send is None:
        return k
    if not 0 < k_send <= k:
        raise ValueError(f"need 0 < k_send <= k, got {k_send} / {k}")
    return int(k_send)


def _payload_out(out, nb: int, k: int, block_size: int, vdt, dev):
    if out is None:
        out = (torch.empty((nb, k), dtype=index_dtype(block_size), device=dev),
               torch.empty((nb, k), dtype=vdt, device=dev),
               torch.empty(nb, dtype=torch.float32, device=dev))
    idx, val, scales = out[:3]
    check(idx, "idx", index_dtype(block_size), (nb, k), dev)
    check(val, "val", vdt, (nb, k), dev)
    check(scales, "scales", torch.float32, (nb,), dev)
    return out


def ef_topk_fused(g: torch.Tensor, e: torch.Tensor, gamma, mask_self,
                  k: int, block_size: int, value_dtype: str = "float32",
                  want_c: bool = False,
                  out: Optional[Tuple[torch.Tensor, ...]] = None,
                  k_send: Optional[int] = None,
                  acc: Optional[torch.Tensor] = None):
    """Fused local COCO-EF step on the block top-K wire, one pass over g
    and e: acc = gamma*g + e; per block the k largest |acc| in `lax.top_k`
    order; scale = block max |acc| (1.0 if 0); val = value_dtype(sv/scale)
    in the first k_send slots, +0 in the others; c = scatter(val*scale);
    e_new = mask_self > 0 ? acc - c : e.

    k_send (default k): a coding rank's budget on a wire shaped by the
    largest budget k.  The first k_send slots are the top-k_send set, so
    this is JAX's per-rank budget branch (pack, zero the values past the
    budget, unpack into c) in one pass.

    g, e: (n,) f32 or bf16, widened in registers; gamma, mask_self:
    scalars (device tensors cost no host copy, see
    `sign_pack.ef_sign_fused`).  `out` = (idx (n/B, k) index dtype, val
    (n/B, k) value dtype, scales (n/B,) f32, e_new (n,) in e's dtype) to
    write into; e_new may be `e` itself.  A bf16 e_new is the f32 value
    rounded once.  Returns (idx, val, scales, c (f32) or None, e_new).

    On the global route (`is_global(block_size)`) acc = gamma*g + e is
    written into `acc` ((n,) f32; default g, which must then be f32), on
    either device, and there are no budgets (k_send = k)."""
    n, dev = g.numel(), g.device
    vdt = ref.wire_dtype(value_dtype)
    _check_shape(n, k, block_size, vdt, dev, global_route=True)
    k_send = _k_send(k_send, k)
    glob = is_global(block_size)
    if glob and k_send != k:
        raise ValueError("the global route takes no per-rank budget")
    check_dtype(g, "g")
    check_dtype(e, "e")
    check(g, "g", g.dtype, (n,), dev)
    check(e, "e", e.dtype, (n,), dev)
    nb = n // block_size
    if out is None:
        out = _payload_out(None, nb, k, block_size, vdt, dev) + (
            torch.empty(n, dtype=e.dtype, device=dev),)
    idx, val, scales, e_new = _payload_out(out, nb, k, block_size, vdt, dev)
    check(e_new, "e_new", e.dtype, (n,), dev)
    gamma_t, mask_t = scalar(gamma, dev), scalar(mask_self, dev)
    if glob:
        acc = g if acc is None else acc
        check(acc, "acc", torch.float32, (n,), dev)

    if dev.type == "cpu":
        i, v, s, c, en = ref.ef_topk_fused_ref(g, e, gamma_t, mask_t, k,
                                               block_size, value_dtype,
                                               k_send)
        if glob:
            ref.mul_add_into(acc, gamma_t, g, e)
        idx.copy_(i)
        val.copy_(v)
        scales.copy_(s)
        e_new.copy_(en)
        return idx, val, scales, (c if want_c else None), e_new
    if glob:
        return ef_topk_global(g, e, gamma_t, mask_t, k, block_size,
                              value_dtype, want_c, (idx, val, scales, e_new),
                              acc=acc)

    c = torch.empty(n, dtype=torch.float32, device=dev) if want_c else None
    bill = (cost.ef_topk_fused, n, block_size, k, g.element_size(),
            e.element_size(), idx.element_size(), val.element_size())
    if dev.type == "meta":
        charge("ef_topk_fused", *bill)
        return idx, val, scales, c, e_new
    err = _lib().ef_topk_fused_launch(
        g.data_ptr(), e.data_ptr(), gamma_t.data_ptr(), mask_t.data_ptr(),
        idx.data_ptr(), val.data_ptr(), scales.data_ptr(),
        c.data_ptr() if c is not None else None, e_new.data_ptr(),
        n, block_size, k, k_send, int(vdt == torch.bfloat16),
        dtype_code(g, e), stream(dev))
    raise_if(err, "ef_topk_fused")
    launches["ef_topk_fused"] += 1
    charge("ef_topk_fused", *bill)
    return idx, val, scales, c, e_new


def topk_pack(x: torch.Tensor, k: int, block_size: int,
              value_dtype: str = "float32",
              out: Optional[Tuple[torch.Tensor, ...]] = None,
              k_send: Optional[int] = None, gamma=None):
    """Pack only: x (n,) f32 or bf16, acc = gamma * x rounded once in f32
    (acc = x when gamma is None) -> (idx (n/B, k), val =
    value_dtype(sv/scale) (n/B, k), +0 past slot k_send (default k),
    scales (n/B,) f32) of acc, written into `out` when given.  gamma is
    COCO's step size, folded into the pack (see `sign_pack.sign_pack`);
    the global route takes an f32 x and no gamma."""
    n, dev = x.numel(), x.device
    vdt = ref.wire_dtype(value_dtype)
    _check_shape(n, k, block_size, vdt, dev, global_route=True)
    k_send = _k_send(k_send, k)
    check_dtype(x, "x")
    check(x, "x", x.dtype, (n,), dev)
    idx, val, scales = _payload_out(out, n // block_size, k, block_size,
                                    vdt, dev)
    gamma_t = None if gamma is None else scalar(gamma, dev)
    if dev.type in ("cuda", "meta") and is_global(block_size):
        if k_send != k:
            raise ValueError("the global route takes no per-rank budget")
        if gamma is not None or x.dtype != torch.float32:
            raise ValueError("the global route packs an f32 acc, no gamma")
        return topk_pack_global(x, k, block_size, value_dtype,
                                (idx, val, scales))
    if dev.type == "cpu":
        i, v, s = ref.topk_pack_ref(x, k, block_size, k_send, gamma_t)
        idx.copy_(i)
        val.copy_(v)
        scales.copy_(s)
        return idx, val, scales
    bill = (cost.topk_pack, n, block_size, k, x.element_size(),
            idx.element_size(), val.element_size(), gamma is not None)
    if dev.type == "meta":
        charge("topk_pack", *bill)
        return idx, val, scales
    err = _lib().topk_pack_launch(
        x.data_ptr(), None if gamma_t is None else gamma_t.data_ptr(),
        idx.data_ptr(), val.data_ptr(), scales.data_ptr(), n, block_size,
        k, k_send, int(vdt == torch.bfloat16),
        int(x.dtype == torch.bfloat16), stream(dev))
    raise_if(err, "topk_pack")
    launches["topk_pack"] += 1
    charge("topk_pack", *bill)
    return idx, val, scales


def topk_decode_reduce(idx: torch.Tensor, val: torch.Tensor,
                       scales: torch.Tensor, mask: torch.Tensor,
                       block_size: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Server-side decode + masked sum over senders, in sender order:
    idx (N, n/B, k), val (N, n/B, k), scales (N, n/B) f32, mask (N,) f32
    -> (n,) f32, written into `out` when given (16-byte aligned on CUDA).
    Preconditions: a pack's k indices in a block are distinct; an index
    >= B adds nothing on CUDA.

    The kernel walks tiles of DECODE_TILE coordinates (DECODE_TILE / B
    blocks) on a persistent grid: per tile, each sender's index, value and
    scale runs are bulk-copied into a ring in shared memory, added in
    sender order into an f32 tile there, and the tile is bulk-stored
    (`csrc/topk_pack.cu`).  Any N, any n/B (a last partial tile), and rows
    at any element offset are taken."""
    dev = idx.device
    if idx.dim() != 3:
        raise ValueError(f"idx: need (N, n/B, k), got {tuple(idx.shape)}")
    N, nb, k = idx.shape
    n = nb * block_size
    _check_shape(n, k, block_size, val.dtype, dev, global_route=True)
    check(idx, "idx", index_dtype(block_size), (N, nb, k), dev)
    check(val, "val", val.dtype, (N, nb, k), dev)
    check(scales, "scales", torch.float32, (N, nb), dev)
    check(mask, "mask", torch.float32, (N,), dev)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=dev)
    check(out, "out", torch.float32, (n,), dev)

    if dev.type == "cpu":
        return out.copy_(ref.topk_decode_reduce_ref(idx, val, scales, mask,
                                                    block_size))
    if is_global(block_size):
        return topk_decode_global(idx, val, scales, mask, block_size, out)
    bill = (cost.topk_decode_reduce, N, n, block_size, k,
            idx.element_size(), val.element_size())
    if dev.type == "meta":
        charge("topk_decode_reduce", *bill)
        return out
    if out.data_ptr() % 16:
        raise ValueError("out: the kernel bulk-stores tiles, need 16-byte "
                         "alignment")
    err = _lib().topk_decode_reduce_launch(
        idx.data_ptr(), val.data_ptr(), scales.data_ptr(), mask.data_ptr(),
        out.data_ptr(), N, n, block_size, k,
        int(val.dtype == torch.bfloat16), stream(dev))
    raise_if(err, "topk_decode_reduce")
    launches["topk_decode_reduce"] += 1
    charge("topk_decode_reduce", *bill)
    return out


def block_topk(x: torch.Tensor, k: int, block_size: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparsify: x (n,) f32 or bf16 -> (n,) of the same dtype keeping each
    block's k largest |x| (the `lax.top_k` set; ROADMAP C8) with their
    bits, +0.0 elsewhere; written into `out` when given (`out` may be
    `x`).  The kernel takes B in BLOCK_TOPK_SIZES and 1 <= k <= K_MAX."""
    n, dev = x.numel(), x.device
    _check_shape(n, k, block_size, x.dtype, dev, BLOCK_TOPK_SIZES)
    check(x, "x", x.dtype, (n,), dev)
    if out is None:
        out = torch.empty_like(x)
    check(out, "out", x.dtype, (n,), dev)
    if dev.type == "cpu":
        return out.copy_(ref.block_topk_ref(x, k, block_size))
    bill = (cost.block_topk, n, k, x.element_size())
    if dev.type == "meta":
        charge("block_topk", *bill)
        return out
    err = _lib().block_topk_launch(
        x.data_ptr(), out.data_ptr(), n, block_size, k,
        int(x.dtype == torch.bfloat16), stream(dev))
    raise_if(err, "block_topk")
    launches["block_topk"] += 1
    charge("block_topk", *bill)
    return out


# --- the global route (see the module docstring) ---------------------------

def global_rounds(block_size: int, k: int) -> int:
    """The B6 launches of one `global_select` over chunks of block_size
    (one launch a round, all chunks together)."""
    m, rounds = block_size, 0
    while rounds == 0 or m > FINAL_SORT:
        m = -(-m // ROUND_BLOCK) * k
        rounds += 1
    return rounds


def global_select(x: torch.Tensor, k: int, nd: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest |x| of each of the nd equal chunks of x (n,) f32, in
    `lax.top_k` order: (positions in the chunk (nd, k) int64, the entries
    themselves (nd, k) f32).  Rounds of B6 (`topk_pack` on blocks of
    ROUND_BLOCK: the kernel on CUDA, its plain version on the CPU), then
    one stable sort of at most FINAL_SORT candidates per chunk."""
    X, P = x.view(nd, -1), None
    while P is None or X.shape[1] > FINAL_SORT:
        m = X.shape[1]
        mp = -(-m // ROUND_BLOCK) * ROUND_BLOCK
        if mp != m:                      # +0 after the chunk's candidates
            X = torch.cat([X, X.new_zeros((nd, mp - m))], 1)
            if P is not None:
                P = torch.cat([P, P.new_full((nd, mp - m), -1)], 1)
        idx, _, _ = topk_pack(X.reshape(-1), k, ROUND_BLOCK)
        base = torch.arange(0, mp, ROUND_BLOCK, device=x.device)
        cand = (base.view(1, -1, 1) + idx.view(nd, -1, k).to(torch.int64)
                ).view(nd, -1)           # (block, slot) order
        P = cand if P is None else torch.gather(P, 1, cand)
        X = torch.gather(X, 1, cand)
    order = torch.sort(X.abs(), dim=1, descending=True,
                       stable=True).indices[:, :k]
    return torch.gather(P, 1, order), torch.gather(X, 1, order)


def _pack_global(x, k, nd, out):
    """Select and write the payload (idx, val, scales) into `out`; returns
    (positions in the chunk (nd, k) int64, c at them (nd, k) f32)."""
    idx, val, scales = out
    pos, sv = global_select(x, k, nd)
    safe = ref._safe_scale(sv)
    val.copy_(sv / safe[:, None])
    scales.copy_(safe)
    idx.copy_(pos)
    return pos, val.to(torch.float32) * safe[:, None]


def topk_pack_global(x: torch.Tensor, k: int, block_size: int,
                     value_dtype: str = "float32",
                     out: Optional[Tuple[torch.Tensor, ...]] = None):
    """`topk_pack` at a block of n / nd by the global route, on either
    device: the plain version's payload bit for bit."""
    n, dev = x.numel(), x.device
    vdt = ref.wire_dtype(value_dtype)
    out = _payload_out(out, n // block_size, k, block_size, vdt, dev)
    _pack_global(x, k, n // block_size, out)
    return out


def ef_topk_global(g: torch.Tensor, e: torch.Tensor, gamma, mask_self,
                   k: int, block_size: int, value_dtype: str = "float32",
                   want_c: bool = False,
                   out: Optional[Tuple[torch.Tensor, ...]] = None,
                   acc: Optional[torch.Tensor] = None):
    """`ef_topk_fused` at a block of n / nd by the global route, on either
    device: the plain version's payload, c and e' bit for bit; acc =
    gamma*g + e is written into `acc` ((n,) f32; default g, then f32).
    g and e f32 or bf16; e' in e's dtype, rounded once.  `out` = (idx,
    val, scales, e_new), e_new may be e.  Returns (idx, val, scales, c or
    None, e_new)."""
    n, dev = g.numel(), g.device
    vdt = ref.wire_dtype(value_dtype)
    if out is None:
        out = _payload_out(None, n // block_size, k, block_size, vdt,
                           dev) + (torch.empty_like(e),)
    nd, e_new = n // block_size, out[3]
    acc = ref.mul_add_into(g if acc is None else acc, gamma, g, e)
    pos, c_kept = _pack_global(acc, k, nd, out[:3])
    keep = ref.as_f32(mask_self, g) > 0
    for i in range(0, n, ref.CHUNK):           # acc - (+0) off the kept set
        sl = slice(i, i + ref.CHUNK)
        e_new[sl] = torch.where(keep, acc[sl], e[sl])
    rows = e_new.view(nd, block_size)
    rows.scatter_(1, pos, torch.where(
        keep, acc.view(nd, block_size).gather(1, pos) - c_kept,
        rows.gather(1, pos)).to(e_new.dtype))
    c = None
    if want_c:
        c = torch.zeros(n, dtype=torch.float32, device=dev)
        c.view(nd, block_size).scatter_(1, pos, c_kept)
    return out[0], out[1], out[2], c, e_new


def topk_decode_global(idx: torch.Tensor, val: torch.Tensor,
                       scales: torch.Tensor, mask: torch.Tensor,
                       block_size: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`topk_decode_reduce` at a block of n / nd, on either device: +0
    everywhere but the union of the senders' kept positions, and there the
    sender-order sum of mask_i * (val * scale, or +0 where sender i kept
    nothing), as JAX's `topk_decode_reduce_scan`."""
    N, nd, k = idx.shape
    dev = idx.device
    if out is None:
        out = torch.empty(nd * block_size, dtype=torch.float32, device=dev)
    base = torch.arange(nd, device=dev).view(1, -1, 1) * block_size
    P = (base + idx.to(torch.int64)).view(N, nd * k)
    SV = (val.to(torch.float32) * scales[..., None]).view(N, nd * k)
    union = P.view(-1)                 # with repeats: each gets one value
    slot = torch.arange(nd * k, device=dev)
    acc = torch.zeros(union.numel(), dtype=torch.float32, device=dev)
    for i in range(N):
        eq = union[:, None] == P[i][None, :]
        term = torch.where(eq.any(1), SV[i][(eq * slot).amax(1)], 0.0)
        acc = acc + mask[i] * term
    out.zero_()
    return out.scatter_(0, union, acc)
