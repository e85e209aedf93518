"""Deterministic synthetic LM batches for the coded train step (port of
`repro.data.pipeline`: synthetic_lm_batch, coded_train_batch and
elastic_train_batch).

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
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.coding import Allocation

__all__ = ["synthetic_lm_batch", "coded_train_batch", "elastic_train_batch",
           "xla_cpu_exp_f32"]

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
