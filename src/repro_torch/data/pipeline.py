"""Deterministic synthetic LM batches for the coded train step, and the
host-to-device prefetcher (port of `repro.data.pipeline`).

The same streams as the JAX pipeline, from `core/prng.py`'s copy of
`jax.random`: subset k of step t draws from
fold_in(fold_in(PRNGKey(seed), k), t), so every rank that holds subset k
regenerates the identical rows without coordination.  Zipf-ish unigrams by
inverse CDF on exponential ranks, floor(exp(u * log V)) - 1 with u uniform
in [1e-6, 1) and log V in f32, then a copy-previous-token perturbation
with probability 0.25 from fold_in(key, 1).  Every step equals JAX's bit
for bit, the f32 exp included: `xla_cpu_exp_f32` is a numpy copy of the
exp that XLA:CPU compiles (a floor exp of an f32 lands on the other
integer wherever two exps differ by an ulp near one, so torch's exp gave
other tokens at some 1e-4 of the positions).

What `xla_cpu_exp_f32` copies, and where it was read
-----------------------------------------------------
jax 0.9.0 on x86-64 (AVX-512), `jax.jit(repro.data.pipeline
.synthetic_lm_batch)` under `XLA_FLAGS=--xla_dump_to=DIR`: the fusion
`multiply_exponential_fusion` holds the uniform, u * log V and the exp;
its `*.ir-with-opt.ll` gives the operations and constants, and
`objdump -d` of its `obj-file.*.o` shows which multiply-adds the backend
fused (the IR carries no `contract` flags, yet the object has 10 vfmadd
per vector of 8 floats).  `jax.jit(jnp.exp)` compiles the same sequence.
In f32, with the constants as their bits:

  x = min(max(x, -87.8 [0xc2af999a]), 88.8 [0x42b1999a])
  n = floor(fma(x, log2(e) [0x3fb8aa3b], 0.5)), clamped to [-127, 127]
  r = fma(n, -0.6933594 [0x3f318000], x)           the Cody-Waite split
  r = fma(n, 2.1219444e-4 [-(0xb95e8083)], r)      of n * log(2)
  p = fma(r, p, c) from p = 1.9875691e-4 [0x39506967] over
      c = 1.3981999e-3 [0x3ab743ce], 8.333452e-3 [0x3c088908],
      4.1665796e-2 [0x3d2aa9c1], 0.16666666 [0x3e2aaaaa], 0.5
  y = (fma(p, r * r, r) + 1) * 2**n     (2**n from the exponent bits
                                         n + 127; n = -127 gives +0)
  a denormal y is flushed to +0 (XLA:CPU sets FTZ/DAZ, ROADMAP C6)

Every fma above is a vfmadd of the object, every other operation a
plain rounded f32 vmul/vadd.  u * log V is its own vmulps (the max of
the uniform stands between it and the uniform's own multiply-add), and
log V is f32(log 256000) = 0x41473f36 in the IR.  The copy is only as
good as the CPU XLA ran on: tests/test_torch_prng.py holds it against
live `jnp.exp` on 2**22 inputs and the port's tokens against JAX's.

The prefetcher
--------------
`prefetch_to_device(it, size, device)` is JAX's: a host thread pulls from
`it` and parks up to `size` staged items in a bounded queue, with JAX's
`PrefetchStats` counters.  On a CUDA device the thread copies each
tensor into pinned memory and on to the device with non_blocking=True
on a side stream, records an event, and the consumer's stream waits on
that event before the step reads the batch (and the tensors are
recorded on the consumer's stream, so the allocator cannot hand their
memory back early).  A producer's exception re-raises at the consumer's
next pull; `close()`, exhaustion and `__del__` stop and join the thread.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.coding import Allocation

__all__ = ["SyntheticLMConfig", "synthetic_lm_batch", "subset_batch_for_rank",
           "coded_train_batch", "elastic_train_batch", "coded_batch_stream",
           "prefetch_to_device", "PrefetchStats", "host_stream",
           "to_device", "xla_cpu_exp_f32"]

PREFETCH_THREAD = "repro_torch-prefetch"


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_subsets: int = 0          # 0 => one subset per DP rank (plain DP)
    seed: int = 0

    def subsets(self, num_dp_ranks: int) -> int:
        return self.num_subsets or num_dp_ranks

_EXP_LO, _EXP_HI = np.uint32(0xC2AF999A), np.uint32(0x42B1999A)
_LOG2E = np.uint32(0x3FB8AA3B)
_LN2_HI, _LN2_LO = np.uint32(0x3F318000), np.uint32(0xB95E8083)
_EXP_POLY = tuple(np.uint32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908,
                                         0x3D2AA9C1, 0x3E2AAAAA, 0x3F000000))


def _f32(bits: np.uint32) -> np.float32:
    return np.array(bits, np.uint32).view(np.float32)[()]


def xla_cpu_exp_f32(x: np.ndarray) -> np.ndarray:
    """exp of f32 `x` exactly as XLA:CPU computes it (the sequence in the
    module docstring): f32 numpy, each fma rounded once by
    `prng.fma_f32`, every other operation rounded as numpy's f32 ops."""
    x = np.asarray(x, np.float32)
    f = _f32
    x = np.where(x < f(_EXP_LO), f(_EXP_LO), x)     # NaN passes, as the
    x = np.where(x > f(_EXP_HI), f(_EXP_HI), x)     # IR's fcmp uge/ule
    n = np.floor(prng.fma_f32(x, f(_LOG2E), np.float32(0.5)))
    n = np.clip(n, np.float32(-127), np.float32(127))
    r = prng.fma_f32(n, -f(_LN2_HI), x)
    r = prng.fma_f32(n, -f(_LN2_LO), r)
    p = np.full_like(x, f(_EXP_POLY[0]))
    for c in _EXP_POLY[1:]:
        p = prng.fma_f32(r, p, f(c))
    y = prng.fma_f32(p, r * r, r) + np.float32(1.0)
    two_n = ((n.astype(np.int32) + 127) << 23).astype(np.uint32)
    with np.errstate(over="ignore"):
        out = y * two_n.view(np.float32)
    # XLA:CPU runs with denormals flushed: a denormal result is +0
    return np.where(out < np.finfo(np.float32).tiny, np.float32(0.0), out)


def synthetic_lm_batch(key: np.ndarray, step: int, batch: int, seq_len: int,
                       vocab: int) -> torch.Tensor:
    """(batch, seq_len+1) int64 tokens (CPU), deterministic in (key, step),
    as JAX's `synthetic_lm_batch(key, step, ...)`."""
    k = prng.fold_in(key, step)
    shape = (batch, seq_len + 1)
    u = prng.uniform(k, shape, 1e-6, 1.0)
    log_v = np.float32(math.log(float(vocab)))
    ranks = np.floor(xla_cpu_exp_f32(u * log_v)) - np.float32(1.0)
    toks = torch.from_numpy(ranks.astype(np.int64)).clamp(0, vocab - 1)
    copy = torch.from_numpy(prng.uniform(prng.fold_in(k, 1), shape) < 0.25)
    return torch.where(copy, torch.roll(toks, 1, dims=-1), toks)


def subset_batch_for_rank(key: np.ndarray, step: int, subset_ids: np.ndarray,
                          subset_weights: np.ndarray, per_subset: int,
                          seq_len: int, vocab: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The union of a rank's subsets for one step (JAX's): tokens
    (n_local * per_subset, L+1) int64, subset k's rows keyed by
    fold_in(key, k), and the per-example weights (f32, subset_weights[j]
    repeated per_subset times)."""
    toks = _rank_tokens(key, step, np.asarray(subset_ids), per_subset,
                        seq_len, vocab)
    w = np.repeat(np.asarray(subset_weights, np.float32), per_subset)
    return toks, torch.from_numpy(w.astype(np.float32))


def _rank_tokens(key: np.ndarray, step: int, sids: np.ndarray,
                 per_subset: int, seq_len: int, vocab: int) -> torch.Tensor:
    """A rank's rows: per_subset rows of each of its subsets, in order."""
    return torch.cat([synthetic_lm_batch(prng.fold_in(key, int(k)), step,
                                         per_subset, seq_len, vocab)
                      for k in sids], 0)


def coded_train_batch(seed: int, step: int, allocation: Allocation,
                      W: np.ndarray, per_subset: int, seq_len: int,
                      vocab: int, ranks: Optional[Sequence[int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One global coded batch: (tokens (N, b_loc, L+1) int64, weights
    (N, b_loc) f32), or only the rows of `ranks` (a coding rank of a
    process grid makes its own).  Rank i's rows are its subsets' rows; the
    per-example weight folds W[i, k] / per_subset (f32 numpy, as the JAX
    batch maker does), so stage 1's weighted backward pass is the coded
    sum of eq. 3."""
    Wn = np.asarray(W, np.float32)
    key = prng.PRNGKey(seed)
    toks, wts = [], []
    for i in (range(allocation.num_devices) if ranks is None else ranks):
        sids = allocation.subsets_of(i)
        toks.append(_rank_tokens(key, step, sids, per_subset, seq_len, vocab))
        w = np.repeat(Wn[i, sids] / per_subset, per_subset)
        wts.append(torch.from_numpy(w.astype(np.float32)))
    return torch.stack(toks), torch.stack(wts)


def elastic_train_batch(seed: int, step: int, allocation: Allocation,
                        per_subset: int, seq_len: int, vocab: int,
                        ranks: Optional[Sequence[int]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`coded_train_batch` with the encode weights left out: (tokens
    (N, b_loc, L+1) int64, weights (N, b_loc) f32 = 1, subset_ids
    (N, b_loc) int64), or the rows of `ranks`.  The elastic step gathers
    each example's weight W_scaled[rank, subset_id] from the live
    `CodingState` (`launch.train.elastic_coding_state` divides by
    per_subset on the host, the static path's f32 division), so with the
    same W both paths give the same weights bit for bit; the tokens are
    `coded_train_batch`'s.  Needs the same subset count on every rank (the
    stacked shape must stay put across re-allocations):
    `rate_aware_allocation(..., exact_load=True)`, or `cyclic_allocation`
    with N | d*M."""
    counts = np.asarray(allocation.S).sum(axis=1)
    if np.any(counts != counts[0]):
        raise ValueError(
            f"elastic batches need a uniform per-rank subset count, got "
            f"loads {counts.tolist()} — use rate_aware_allocation("
            f"exact_load=True)")
    key = prng.PRNGKey(seed)
    toks, sids_out = [], []
    for i in (range(allocation.num_devices) if ranks is None else ranks):
        sids = allocation.subsets_of(i)
        toks.append(_rank_tokens(key, step, sids, per_subset, seq_len, vocab))
        sids_out.append(torch.from_numpy(
            np.repeat(sids.astype(np.int64), per_subset)))
    tokens = torch.stack(toks)
    return (tokens, torch.ones(tokens.shape[:2], dtype=torch.float32),
            torch.stack(sids_out))


def coded_batch_stream(seed: int, allocation: Allocation, W: np.ndarray,
                       per_subset: int, seq_len: int, vocab: int,
                       start_step: int = 0
                       ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """`coded_train_batch(seed, t, ...)` for t = start_step, start_step+1,
    ...: deterministic in (seed, step), so prefetching cannot change what
    any step trains on."""
    step = start_step
    while True:
        yield coded_train_batch(seed, step, allocation, W, per_subset,
                                seq_len, vocab)
        step += 1


def host_stream(cfg: SyntheticLMConfig, start_step: int = 0
                ) -> Iterator[torch.Tensor]:
    """Host-side infinite stream of global batches (single-host testing)."""
    key = prng.PRNGKey(cfg.seed)
    step = start_step
    while True:
        yield synthetic_lm_batch(key, step, cfg.global_batch, cfg.seq_len,
                                 cfg.vocab_size)
        step += 1


@dataclasses.dataclass
class PrefetchStats:
    """Host-side counters of one `prefetch_to_device` stream (JAX's).
    Single writer per field (the worker owns the producer's counters, the
    consumer the rest):

      put_count        batches staged (copy issued, parked in the queue)
      get_count        batches the consumer pulled
      producer_wait_s  worker time blocked on a FULL queue
      consumer_wait_s  consumer time blocked on an EMPTY queue (the
                       host's batch on the step's critical path)
      device_put_s     worker time inside the host->device staging
      max_depth        high-water queue occupancy (<= size)
      depth_sum        sum of the occupancies seen at each get
    """

    size: int = 0
    put_count: int = 0
    get_count: int = 0
    producer_wait_s: float = 0.0
    consumer_wait_s: float = 0.0
    device_put_s: float = 0.0
    max_depth: int = 0
    depth_sum: int = 0

    def snapshot(self) -> dict:
        """Plain-dict copy (the `prefetch` JSONL record's `stats` body)."""
        return dataclasses.asdict(self)


def _map_leaves(fn, item):
    if isinstance(item, (torch.Tensor, np.ndarray)):
        return fn(item)
    if isinstance(item, dict):
        return {k: _map_leaves(fn, v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_map_leaves(fn, v) for v in item)
    return item


def _stage(x, device: torch.device) -> torch.Tensor:
    """One leaf to `device`: through pinned memory with a non-blocking
    copy when the device is a CUDA card (the caller's current stream)."""
    t = torch.as_tensor(x)
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def to_device(item, device) -> object:
    """Every tensor or array leaf of a tuple/list/dict tree on `device`."""
    device = torch.device(device)
    return _map_leaves(lambda x: _stage(x, device), item)


def _stager(device: torch.device, put: Callable) -> Callable:
    """item -> (staged item, the CUDA event its copies end with, or
    None): on a card the copies run on a side stream of their own."""
    if device.type != "cuda":
        return lambda item: (put(item, device), None)
    stream = torch.cuda.Stream(device)

    def stage(item):
        with torch.cuda.device(device), torch.cuda.stream(stream):
            item = put(item, device)
            ev = torch.cuda.Event()
            ev.record(stream)
        return item, ev
    return stage


def _worker(it, stage, q, stop, stats, sentinel, err) -> None:
    try:
        for item in it:
            t0 = time.perf_counter()
            staged = stage(item)
            stats.device_put_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            while not stop.is_set():
                try:
                    q.put(staged, timeout=0.1)
                    stats.put_count += 1
                    break
                except queue.Full:
                    continue
            stats.producer_wait_s += time.perf_counter() - t0
            if stop.is_set():
                return
    except BaseException as exc:       # re-raised on the consumer side
        err.append(exc)
    finally:
        while not stop.is_set():
            try:
                q.put(sentinel, timeout=0.1)
                break
            except queue.Full:
                continue


class _DevicePrefetch:
    """Iterator form of `prefetch_to_device` exposing `.stats`.  The
    worker holds no reference to this object, so dropping the last one
    runs `__del__`, which stops and joins it."""

    def __init__(self, it: Iterator, size: int, device, put: Callable):
        if size < 1:
            raise ValueError("prefetch size must be >= 1")
        self.stats = PrefetchStats(size=size)
        self._device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._sentinel = object()
        self._err: list = []
        self._done = False
        stage = _stager(self._device, put)
        self._th = threading.Thread(
            target=_worker, name=PREFETCH_THREAD, daemon=True,
            args=(it, stage, self._q, self._stop, self.stats,
                  self._sentinel, self._err))
        self._th.start()

    def __iter__(self) -> "_DevicePrefetch":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        stats = self.stats
        depth = self._q.qsize()
        stats.max_depth = max(stats.max_depth, depth)
        stats.depth_sum += depth
        t0 = time.perf_counter()
        got = self._q.get()
        stats.consumer_wait_s += time.perf_counter() - t0
        if got is self._sentinel:
            self._done = True
            self.close()
            if self._err:
                raise self._err[0]
            raise StopIteration
        stats.get_count += 1
        item, ev = got
        if ev is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ev)

            def mark(x):
                if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                    x.record_stream(consumer)
                return x
            _map_leaves(mark, item)
        return item

    def close(self) -> None:
        """Stop and join the worker (idempotent)."""
        self._done = True
        self._stop.set()
        while True:             # unblock a worker stuck on q.put
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._th.join(timeout=5.0)

    def __del__(self):
        try:
            if not self._done:
                self.close()
        except Exception:
            pass


def prefetch_to_device(it: Iterator, size: int = 2, device="cuda",
                       put: Optional[Callable] = None) -> _DevicePrefetch:
    """Host -> device prefetcher (JAX's): a background thread pulls from
    `it`, stages each item on `device` (`put(item, device)`, default
    `to_device`) and parks up to `size` staged items in a bounded queue.
    Order is preserved and nothing is dropped, so consuming it gives what
    mapping `put` over `it` gives.  `.stats` is a `PrefetchStats`;
    `.close()` stops and joins the worker; an exception raised by `it` or
    by the staging re-raises at the consumer's next pull."""
    return _DevicePrefetch(it, size, device, put or to_device)
