"""COCO-EF over flat state (port of `repro.core.cocoef`: the cocoef, coco
and dense modes, on the sign, block top-K, global top-K and dense wires,
with buckets and phase 2), in two forms: every coding rank on one device
(`cocoef_update`), or one process per coding rank over `torch.distributed`
(`group_cocoef_update`).

On one device all N coding ranks share it.  Each rank's error vector is one row
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

Buckets.  `num_buckets` splits the flat vector into equal parts (the flat
size is padded to a multiple of chunk_ranks * pad_multiple * buckets),
each with its own wire, payload and collective: global top-K's k per
bucket is ceil(topk_k / (nd * buckets)).  Every value is elementwise in
the bucket, so the split changes no bit on the sign and block top-K wires
(groups and blocks never straddle a bucket).  `bucket_schedule` orders the
issue (JAX's `_BucketSchedule`): "serial" finishes bucket b (decode and
phase 2) before bucket b+1's local step; "pipelined" finishes it only
after bucket b+1's local step and all_to_all were issued, so a transfer
can overlap the next bucket's compute.  The same operations run on the
same data, so both give the same bits.  On one device the rank loop is
outermost (the ranks share one gradient buffer), and the schedule orders
the decodes against the last rank's local steps.

Phase 2 (`phase2_dtype`, `phase2_sign`) is what the all_gather returns to
every rank: the aggregate in f32, rounded through bf16, or re-packed on
the sign wire (group_size) and unpacked.  Dense mode has no phase 2, as in
JAX (its psum returns f32).  On one device phase 2 runs in place on each
bucket of ghat after its decode (`collectives.phase2_local_`); the sign
re-pack writes into row 0 of the bucket's sign payload, which the decode
has finished reading.

Telemetry.  Given a `FrameSums` (`metrics=`), the update also fills the
per-rank fields of a `repro_torch.obs.MetricsFrame` (JAX's
`_cocoef_update_metrics`): a pass before each rank's local step takes
|g|^2 and |acc|^2 (acc re-made chunk by chunk, rounded as the kernels
round it) and, where C(acc) is a function of a chunk of acc (the sign
wire's group scales, the dense wire, dense mode), |c|^2 and <acc, c>; a
pass after it takes |e'|^2 and, on the sparse wires, |c|^2 and <acc, c>
from the payload, with acc at the kept coordinates as c + e' for a
participating rank (exact there with an f32 e) and gamma*g + e for a
straggler (whose e' is e).  With a bf16 e, e' = bf16(acc - c) does not
give acc back, so the pass before keeps acc in ghat's bucket (free until
the decode; global top-K's step keeps it there itself), or, where that
bucket is the f32 gradient, in a buffer of the frame's own.  No pass holds
more than `obs.metrics.CHUNK` elements, and without `metrics` the update
runs exactly as before.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.obs.metrics import CHUNK as FRAME_CHUNK, MetricsFrame, \
    norm_sq

from .collectives import (CodingCollectiveConfig, DenseWire, SignWire, Wire,
                          build_wire, coded_aggregate, coded_allreduce_start,
                          dense_allreduce, phase2_local_)

__all__ = ["CocoEFConfig", "FlatLayout", "flat_layout", "padded_size",
           "cocoef_update", "group_cocoef_update", "group_buffers",
           "bucket_payload", "payload_specs", "MODES", "SCHEDULES", "check_mode",
           "FrameSums"]

MODES = ("cocoef", "coco", "dense")
SCHEDULES = ("serial", "pipelined")


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
    wire_dtype: the sparse wires' value dtype, the dense wire's dtype.
    ef_dtype: the error vectors' storage dtype ("float32" or "bfloat16":
      e' is computed in f32 and rounded once to it, JAX's cast).
    phase2_dtype / phase2_sign: phase 2 (see the module docstring).
    num_buckets / bucket_schedule: buckets and their issue order
      ("pipelined" | "serial"; the same bits)."""

    group_size: int = 512
    mode: str = "cocoef"
    compressor: str = "sign"
    topk_k: int = 64
    k_per_block: Union[int, Tuple[int, ...]] = 8
    block_size: int = 256
    wire_dtype: str = "float32"
    ef_dtype: str = "float32"
    phase2_dtype: str = "float32"
    phase2_sign: bool = False
    num_buckets: int = 1
    bucket_schedule: str = "pipelined"

    def __post_init__(self):
        check_mode(self.mode)
        if self.bucket_schedule not in SCHEDULES:
            raise ValueError(f"unknown bucket_schedule "
                             f"{self.bucket_schedule!r}; have {SCHEDULES}")
        if self.num_buckets < 1:
            raise ValueError(f"num_buckets={self.num_buckets} must be >= 1")
        self.collective()     # validates phase2_dtype
        ref.wire_dtype(self.ef_dtype)
        if self.topk_k < 1:
            raise ValueError(f"need topk_k >= 1, got {self.topk_k}")
        if self.compressor != "topk":
            self.wire  # validates the compressor and the wire's knobs
        else:
            ref.wire_dtype(self.wire_dtype)

    def collective(self) -> CodingCollectiveConfig:
        return CodingCollectiveConfig(group_size=self.group_size,
                                      phase2_dtype=self.phase2_dtype,
                                      phase2_sign=self.phase2_sign)

    def wire_format(self, n: int = 0, nd: int = 1) -> Wire:
        """The wire for one bucket of `n` coordinates over `nd` all_to_all
        chunks (only global top-K depends on them: one block per chunk,
        its budget split over the chunks and buckets)."""
        return build_wire(self.compressor, group_size=self.group_size,
                          k_per_block=self.k_per_block,
                          block_size=self.block_size, topk_k=self.topk_k,
                          value_dtype=self.wire_dtype, n=n, nd=nd,
                          num_buckets=self.num_buckets)

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


def bucket_payload(payload: Tuple[torch.Tensor, ...], b: int,
                   num_buckets: int) -> Tuple[torch.Tensor, ...]:
    """Bucket b's leaves of payload buffers that carry a leading bucket
    dimension when num_buckets > 1 (and none when it is 1)."""
    return payload if num_buckets == 1 else tuple(p[b] for p in payload)


def payload_specs(cfg: CocoEFConfig, n_bucket: int, nd: int
                  ) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each payload leaf of one rank's bucket of
    `n_bucket` coordinates over `nd` chunks: sign (words (n/32,) u32,
    scales (n/g,) f32); block or global top-K (idx (n/B, k_max), values
    (n/B, k_max), scales (n/B,) f32); the dense wire (values (n,))."""
    wire = cfg.wire_format(n_bucket, nd)
    if isinstance(wire, DenseWire):
        return [((n_bucket,), wire.vdt)]
    if cfg.compressor == "sign":
        return [((n_bucket // 32,), torch.uint32),
                ((n_bucket // cfg.group_size,), torch.float32)]
    nb = n_bucket // wire.block_size
    return [((nb, wire.k_max), wire.index_dtype),
            ((nb, wire.k_max), ref.wire_dtype(wire.value_dtype)),
            ((nb,), torch.float32)]


def _check_budgets(wire: Wire, n_code: int) -> None:
    if wire.has_rank_budgets() and len(wire.k_per_block) != n_code:
        raise ValueError(
            f"wire has {len(wire.k_per_block)} per-rank budgets, the "
            f"coding collective has {n_code} ranks")


def _buckets(n: int, num_buckets: int) -> List[slice]:
    if n % num_buckets:
        raise ValueError(f"flat size {n} is not a multiple of num_buckets="
                         f"{num_buckets}; pad with padded_size")
    nb = n // num_buckets
    return [slice(b * nb, (b + 1) * nb) for b in range(num_buckets)]


class _BucketSchedule:
    """The issue order of the buckets' collectives (JAX's
    `_BucketSchedule`, `repro/core/cocoef.py:187-223`).  submit(start,
    finish) issues bucket b (start() returns its handle) and
      serial:     finishes it at once;
      pipelined:  finishes the previous bucket only now, after this one's
                  local step and start were issued, and holds this one.
    The same work runs either way, so the values are the same."""

    def __init__(self, schedule: str):
        self.pipelined = schedule == "pipelined"
        self._pending: Optional[Callable[[], None]] = None

    def submit(self, start: Callable, finish: Callable) -> None:
        handle = start()
        if not self.pipelined:
            finish(handle)
            return
        if self._pending is not None:
            self._pending()
        self._pending = lambda: finish(handle)

    def collect(self) -> None:
        if self._pending is not None:
            self._pending()
            self._pending = None


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> of two flat f32 tensors as float64 (one read of each)."""
    return torch.dot(a, b).to(torch.float64)


def _idx64(idx: torch.Tensor) -> torch.Tensor:
    """Sparse-wire indices (u16 or u32) as int64."""
    if idx.dtype == torch.uint16:
        return idx.view(torch.int16).to(torch.int64) & 0xFFFF
    if idx.dtype == torch.uint32:
        return idx.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return idx.to(torch.int64)


class FrameSums:
    """The per-rank sums of one step's `MetricsFrame`, taken around each
    rank's local step (module docstring, "Telemetry").  `ranks`: the
    coding ranks whose rows this process fills, in row order (all N on one
    device, its own rank with a grid); `nd`: the all_to_all chunk count;
    `n`: the flat size."""

    def __init__(self, cfg: CocoEFConfig, mask: torch.Tensor, gamma,
                 ranks: Sequence[int], nd: int, n: int):
        N, B = mask.shape[0], cfg.num_buckets
        self.cfg, self.rows = cfg, {r: j for j, r in enumerate(ranks)}
        self.gamma = ref.as_f32(gamma, mask)
        f = MetricsFrame.zeros(N, len(ranks), B, mask.device)
        if cfg.mode == "dense":
            rb = DenseWire("float32").rank_wire_bytes(n, N)
            buckets = np.repeat(rb[None].astype(np.float64) / B, B, axis=0)
        else:
            wire = cfg.wire_format(n // B, nd)
            buckets = np.stack([wire.rank_wire_bytes(n // B, N)] * B)
            rb = buckets.sum(axis=0)
        m = mask.to(torch.float64)
        dev = mask.device
        f.participation = m.clone()
        f.wire_bytes_rank = torch.as_tensor(rb, dtype=torch.float64,
                                            device=dev) * m
        rows = torch.as_tensor(np.asarray(buckets, np.float64)[:, list(ranks)]
                               .T.copy(), device=dev)
        f.bucket_wire_bytes = rows * m[list(ranks)][:, None]
        f.bytes_down = torch.tensor(
            float(n * ref.wire_dtype(cfg.phase2_dtype).itemsize),
            dtype=torch.float64, device=dev)
        self.frame = f
        self._spare: Optional[torch.Tensor] = None

    def _sparse(self, wire) -> bool:
        return self.cfg.mode != "dense" and not isinstance(
            wire, (SignWire, DenseWire))

    def keeps_acc(self, wire, e: Optional[torch.Tensor]) -> bool:
        """Whether `after` needs acc kept from `before`: the block top-K
        wire with a bf16 e in cocoef mode, where e' = bf16(acc - c) no
        longer gives acc back as c + e' (global top-K's step leaves acc in
        ghat's bucket itself)."""
        return (self._sparse(wire) and self.cfg.mode == "cocoef"
                and self.cfg.compressor != "topk"
                and e.dtype != torch.float32)

    def acc_buffer(self, g: torch.Tensor, free: Optional[torch.Tensor]
                   ) -> torch.Tensor:
        """An f32 buffer of g's size for `before` to keep acc in: `free`
        (ghat's bucket, unused until the decode) unless it is g itself (an
        f32 gradient buffer that holds ghat), then one of the frame's own,
        made once."""
        if free is not None and free.data_ptr() != g.data_ptr():
            return free
        if self._spare is None or self._spare.numel() != g.numel():
            self._spare = torch.empty(g.numel(), dtype=torch.float32,
                                      device=g.device)
        return self._spare

    def before(self, rank: int, g: torch.Tensor, e: Optional[torch.Tensor],
               wire, free: Optional[torch.Tensor] = None
               ) -> Optional[torch.Tensor]:
        """g and e of one bucket before the local step: |g|^2, |acc|^2,
        and, where C(acc) is a function of a chunk of acc, |c|^2 and
        <acc, c> (g and e f32 or bf16, read widened).  Where `keeps_acc`,
        acc is written into `acc_buffer(g, free)` and returned, for
        `after(acc=)`; else returns None."""
        f, j, cfg = self.frame, self.rows[rank], self.cfg
        ef = cfg.mode == "cocoef"
        kept = self.acc_buffer(g, free) if self.keeps_acc(wire, e) else None
        for i in range(0, g.numel(), FRAME_CHUNK):
            gc = g[i:i + FRAME_CHUNK].to(torch.float32)
            f.grad_norm_sq[j] += _dot(gc, gc)
            acc = gc * self.gamma
            if ef:
                acc.add_(e[i:i + FRAME_CHUNK])
            f.acc_norm_sq[j] += _dot(acc, acc)
            if kept is not None:
                kept[i:i + FRAME_CHUNK] = acc
            if self._sparse(wire):
                continue
            if isinstance(wire, SignWire):
                gs = wire.group_size
                a = acc.abs().view(-1, gs).sum(-1)
                sc = a / gs                       # the group's mean |acc|
                f.c_norm_sq[j] += _dot(sc, sc) * gs
                f.acc_dot_c[j] += _dot(sc, a)
                continue
            c = acc if cfg.mode == "dense" else wire.unpack(wire.pack(acc))
            cc = _dot(c, c)
            f.c_norm_sq[j] += cc
            f.acc_dot_c[j] += cc if c is acc else _dot(acc, c)
        return kept

    def after(self, rank: int, g: torch.Tensor, e: Optional[torch.Tensor],
              payload: Tuple[torch.Tensor, ...], mask_i, wire,
              acc: Optional[torch.Tensor] = None) -> None:
        """One bucket after the local step: |e'|^2 (of e as stored, JAX's
        norm of the cast e) and the sparse wires' |c|^2 and <acc, c>, from
        the payload (idx, values, scales).  acc: the bucket's acc where
        the global route's step or `before` (`keeps_acc`) left it; else
        acc at the kept coordinates is gamma*g in COCO, and c + e' or, for
        a straggler, gamma*g + e (an f32 e)."""
        f, j, cfg = self.frame, self.rows[rank], self.cfg
        if e is not None and cfg.mode == "cocoef":
            f.ef_norm_sq[j] += norm_sq(e)
        if not self._sparse(wire):
            return
        idx, val, scales = payload
        B, k = wire.block_size, idx.shape[-1]
        step = max(1, FRAME_CHUNK // max(B, k))
        for r0 in range(0, idx.shape[0], step):
            r1 = min(r0 + step, idx.shape[0])
            base = torch.arange(r0, r1, dtype=torch.int64,
                                device=g.device)[:, None] * B
            pos = (base + _idx64(idx[r0:r1])).reshape(-1)
            c = (val[r0:r1].to(torch.float32)
                 * scales[r0:r1, None]).reshape(-1)
            f.c_norm_sq[j] += _dot(c, c)
            if acc is not None:
                ak = acc.index_select(0, pos)
            else:
                ak = g.index_select(0, pos).to(torch.float32) * self.gamma
                if cfg.mode == "cocoef":
                    ek = e.index_select(0, pos)
                    ak = torch.where(ref.as_f32(mask_i, c) > 0, c + ek,
                                     ak + ek)
            f.acc_dot_c[j] += _dot(ak, c)

    def finish(self, ghat: torch.Tensor) -> MetricsFrame:
        self.frame.ghat_norm_sq = norm_sq(ghat)
        return self.frame



def cocoef_update(grad_of: Callable[[int], torch.Tensor],
                  e: Optional[torch.Tensor], mask: torch.Tensor, gamma,
                  cfg: CocoEFConfig, payload: Tuple[torch.Tensor, ...],
                  out: Optional[torch.Tensor] = None,
                  kernel_spans: Optional[List] = None,
                  metrics: Optional[FrameSums] = None) -> torch.Tensor:
    """One Algorithm-1 update (or, with cfg.mode "coco", one update without
    error feedback, or with "dense" the uncompressed baseline) for the N
    coding ranks sharing this device.

    grad_of(i): rank i's flat (n,) coded gradient, f32 or bf16 (the
      gradient of bf16 parameters, read widened); it may return the same
      buffer every time (the slice reuses one gradient buffer), because
      rank i's gradient is consumed before grad_of(i+1) is called.  The
      buffer is not written, unless it is `out`.
    e: (N, n) error vectors in cfg.ef_dtype (f32 or bf16), updated in
      place (e' computed in f32 and rounded once); not read in the coco
      and dense modes (may be None there).
    mask: (N,) f32 straggler indicators I_i^t.
    gamma: the learning rate (already inside ghat, eq. 4).
    payload: the wire's payload buffers stacked over ranks, with a leading
      bucket dimension when cfg.num_buckets > 1 (`payload_specs` per rank
      and bucket): sign (words (N, n/32) u32, scales (N, n/g) f32); block
      or global top-K (idx (N, n/B, k), values (N, n/B, k), scales
      (N, n/B) f32); the dense wire and dense mode (ghat (n,) f32,): the
      accumulator.
    out: where to write ghat, (n,) f32; may be an f32 gradient buffer,
      whose bucket b is free once the last rank's local step on it has
      run (default: a new f32 buffer).  Global top-K keeps each rank's
      acc_i in bucket b of it during the local step.  Not used where ghat
      is the accumulator (the dense wire, dense mode).
    kernel_spans: when a list and on CUDA, gets a (start, end) event pair
      around every rank's local step on every bucket (in coco mode its
      pack of gamma*g) and around every bucket's decode and phase 2.
    metrics: a `FrameSums` to fill (module docstring, "Telemetry").
    Returns ghat (n,) f32: apply as  params -= ghat."""
    N, B = mask.shape[0], cfg.num_buckets
    spans = _KernelSpans(kernel_spans, mask.device)
    coll = cfg.collective()
    if cfg.folds:
        ghat = _folded_update(grad_of, e, mask, gamma, cfg, payload[0],
                              spans, metrics)
        if cfg.mode != "dense":               # JAX's dense psum: no phase 2
            for sl in _buckets(ghat.numel(), B):
                with spans:
                    phase2_local_(ghat[sl], coll)
        if metrics is not None:
            metrics.finish(ghat)
        return ghat
    sched = _BucketSchedule(cfg.bucket_schedule)
    wire = ghat = None
    for i in range(N):
        g = grad_of(i)
        if wire is None:
            slices = _buckets(g.numel(), B)
            n_b = g.numel() // B      # global top-K's block is n_b / N
            wire = cfg.wire_format(n_b, N)
            wire.check(n_b, N)
            _check_budgets(wire, N)
            ghat = _f32_out(g, out)
        for b, sl in enumerate(slices):
            pb = bucket_payload(payload, b, B)
            rows = tuple(p[i] for p in pb)
            e_b = e[i, sl] if cfg.mode == "cocoef" else None
            kept = None
            if metrics is not None:
                kept = metrics.before(i, g[sl], e_b, wire, ghat[sl])
            with spans:
                acc = _local_step(cfg, wire, g[sl], e_b, gamma, mask[i],
                                  rows, i, ghat[sl])
            if metrics is not None:      # before the decode reuses ghat
                metrics.after(i, g[sl], e_b, rows, mask[i], wire,
                              kept if acc is None else acc)
            if i == N - 1:
                sched.submit(lambda: None,
                             lambda _, pb=pb, sl=sl: _decode_one(
                                 wire, pb, mask, ghat[sl], coll, spans))
    sched.collect()
    if metrics is not None:
        metrics.finish(ghat)
    return ghat


def _f32_out(g: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """ghat's buffer: `out`, or a new (n,) f32 tensor (ghat is f32 whatever
    g's dtype, as JAX's decode)."""
    if out is None:
        return torch.empty(g.shape, dtype=torch.float32, device=g.device)
    if out.dtype != torch.float32 or out.shape != g.shape:
        raise ValueError(f"ghat's buffer must be ({g.numel()},) f32, got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out


def _local_step(cfg: CocoEFConfig, wire: Wire, g: torch.Tensor,
                e: Optional[torch.Tensor], gamma, mask_i, rows, rank: int,
                acc_buf: torch.Tensor) -> Optional[torch.Tensor]:
    """One rank's local step on one bucket of the sign or sparse wires,
    its payload into `rows` (and e updated in place in cocoef mode).  COCO
    folds gamma into the pack kernel (acc = gamma*g rounded once in f32,
    JAX's gamma * g); global top-K first makes acc in `acc_buf`, an f32
    bucket free until the decode.  Returns that acc, or None."""
    if cfg.compressor == "topk":
        if cfg.mode == "coco":
            ref.gamma_times_into(acc_buf, gamma, g)
            wire.fused_pack(acc_buf, out=rows, rank=rank)
        else:
            wire.fused_local_step(g, e, gamma, mask_i, out=rows + (e,),
                                  rank=rank, acc=acc_buf)
        return acc_buf
    if cfg.mode == "coco":
        wire.fused_pack(g, out=rows, rank=rank, gamma=gamma)
    else:
        wire.fused_local_step(g, e, gamma, mask_i, out=rows + (e,),
                              rank=rank)
    return None


def _decode_one(wire: Wire, pb: Tuple[torch.Tensor, ...], mask, out,
                coll: CodingCollectiveConfig, spans) -> None:
    """One bucket's decode into `out`, then its phase 2 (the sign re-pack
    into row 0 of the bucket's sign payload, free after the decode)."""
    with spans:
        coded_aggregate(wire, pb, mask, out=out)
        rows0 = (pb[0][0], pb[1][0]) if (
            coll.phase2_sign and isinstance(wire, SignWire)) else None
        phase2_local_(out, coll, rows0)


def _folded_update(grad_of, e, mask, gamma, cfg: CocoEFConfig,
                   ghat: torch.Tensor, spans: _KernelSpans,
                   metrics: Optional[FrameSums] = None) -> torch.Tensor:
    """`cocoef_update` where ghat is one accumulator: rank by rank, C(acc_i)
    is made a chunk at a time in f32 (`DenseWire.local_chunks`) and
    mask_i * C(acc_i) added into ghat, from +0.0 in rank order.  Dense mode
    is the f32 identity without error feedback: acc_i = gamma*g_i (one
    rounding) is C(acc_i).  Buckets change no value here (everything is
    elementwise)."""
    wire = cfg.wire if cfg.mode != "dense" else DenseWire()
    with spans:
        ghat.zero_()
    for i in range(mask.shape[0]):
        g = grad_of(i)
        e_i = e[i] if cfg.mode == "cocoef" else None
        if metrics is not None:
            metrics.before(i, g, e_i, wire)
        with spans:
            for sl, c in wire.local_chunks(g, e_i, gamma, mask[i]):
                wire.fold_(ghat[sl], c, mask[i])
        if metrics is not None:
            metrics.after(i, g, e_i, (), mask[i], wire)
    return ghat


def group_buffers(cfg: CocoEFConfig, nd: int, n: int, device
                  ) -> List[Tuple[Tuple[torch.Tensor, ...],
                                  Tuple[torch.Tensor, ...]]]:
    """One (send, receive) pair of payload buffers per bucket for
    `group_cocoef_update` on a grid of `nd` chunk ranks (none in dense
    mode, whose collective makes its own)."""
    if cfg.mode == "dense":
        return []
    specs = payload_specs(cfg, n // cfg.num_buckets, nd)

    def leaves():
        return tuple(torch.zeros(s, dtype=dt, device=device)
                     for s, dt in specs)
    return [(leaves(), leaves()) for _ in range(cfg.num_buckets)]


def group_cocoef_update(g: torch.Tensor, e: Optional[torch.Tensor],
                        mask: torch.Tensor, gamma, cfg: CocoEFConfig, grid,
                        buffers, out: Optional[torch.Tensor] = None,
                        kernel_spans: Optional[List] = None,
                        metrics: Optional[FrameSums] = None
                        ) -> torch.Tensor:
    """`cocoef_update` with one process per coding rank: this process is
    rank grid.rank (`launch.mesh.CodingGrid`) and runs its own local step,
    then the two-phase collective across the grid, bucket by bucket in
    cfg.bucket_schedule's order.

    g: this rank's (n,) coded gradient, f32 or bf16 (not written unless
    it is `out`); e: its (n,) error row in cfg.ef_dtype, updated in place
    (None in the coco and dense modes); mask: (N,) f32 over the grid, on
    g's device; buffers: `group_buffers(cfg, grid.nd, n, device)`; out:
    where ghat goes, (n,) f32 (may be an f32 g; global top-K and dense
    mode keep acc there first).  On a 1-D grid the result is
    `cocoef_update`'s bit for bit (see `core.collectives`).  metrics: a
    `FrameSums` over this rank only (the frame's cross-rank rows wait for
    the driver over a grid, ROADMAP A13).  Returns ghat (n,), the same on
    every rank."""
    me, B = grid.rank, cfg.num_buckets
    spans = _KernelSpans(kernel_spans, g.device)
    ghat = _f32_out(g, out)
    gam = ref.as_f32(gamma, g)
    if cfg.mode == "dense":
        if metrics is not None:
            metrics.before(me, g, None, DenseWire())
        with spans:
            acc = ref.gamma_times_into(ghat, gam, g)
        ghat = dense_allreduce(acc, grid, mask, out=ghat)
        if metrics is not None:
            metrics.finish(ghat)
        return ghat
    coll = cfg.collective()
    slices = _buckets(g.numel(), B)
    n_b = g.numel() // B
    wire = cfg.wire_format(n_b, grid.nd)
    wire.check(n_b, grid.nd)
    _check_budgets(wire, grid.size)
    sched = _BucketSchedule(cfg.bucket_schedule)
    for sl, (send, recv) in zip(slices, buffers):
        g_b = g[sl]
        e_b = e[sl] if cfg.mode == "cocoef" else None
        acc = kept = None
        if metrics is not None:
            kept = metrics.before(me, g_b, e_b, wire, ghat[sl])
        with spans:
            if isinstance(wire, DenseWire):
                for csl, c in wire.local_chunks(g_b, e_b, gam, mask[me]):
                    send[0][csl] = c
            else:
                acc = _local_step(cfg, wire, g_b, e_b, gam, mask[me], send,
                                  me, ghat[sl])
        if metrics is not None:
            metrics.after(me, g_b, e_b, send, mask[me], wire,
                          kept if acc is None else acc)

        def finish(handle, sl=sl):
            with spans:
                handle.finish(ghat[sl])
        sched.submit(lambda send=send, recv=recv: coded_allreduce_start(
            wire, coll, grid, mask, send, recv), finish)
    sched.collect()
    if metrics is not None:
        metrics.finish(ghat)
    return ghat
