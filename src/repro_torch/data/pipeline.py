"""Deterministic synthetic LM batches for the coded train step (port of
`repro.data.pipeline`: synthetic_lm_batch and coded_train_batch).

The same streams as the JAX pipeline, from `core/prng.py`'s copy of
`jax.random`: subset k of step t draws from
fold_in(fold_in(PRNGKey(seed), k), t), so every rank that holds subset k
regenerates the identical rows without coordination.  Zipf-ish unigrams by
inverse CDF on exponential ranks, floor(exp(u * log V)) - 1 with u uniform
in [1e-6, 1) and log V in f32, then a copy-previous-token perturbation
with probability 0.25 from fold_in(key, 1).  The uniforms and the copy
draws equal JAX's bit for bit; the token map's f32 exp is torch's, which
differs from XLA's by an ulp on some inputs, so a token can differ by one
where exp(u * log V) lies within an ulp of an integer
(tests/test_torch_prng.py counts them).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.coding import Allocation

__all__ = ["synthetic_lm_batch", "coded_train_batch"]


def synthetic_lm_batch(key: np.ndarray, step: int, batch: int, seq_len: int,
                       vocab: int) -> torch.Tensor:
    """(batch, seq_len+1) int64 tokens (CPU), deterministic in (key, step),
    as JAX's `synthetic_lm_batch(key, step, ...)`."""
    k = prng.fold_in(key, step)
    shape = (batch, seq_len + 1)
    u = torch.from_numpy(prng.uniform(k, shape, 1e-6, 1.0))
    log_v = torch.tensor(math.log(float(vocab)), dtype=torch.float32)
    ranks = torch.floor(torch.exp(u * log_v)) - 1.0
    toks = ranks.to(torch.int64).clamp(0, vocab - 1)
    copy = torch.from_numpy(prng.uniform(prng.fold_in(k, 1), shape) < 0.25)
    return torch.where(copy, torch.roll(toks, 1, dims=-1), toks)


def coded_train_batch(seed: int, step: int, allocation: Allocation,
                      W: np.ndarray, per_subset: int, seq_len: int,
                      vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One global coded batch: (tokens (N, b_loc, L+1) int64, weights
    (N, b_loc) f32).  Rank i's rows are its subsets' rows; the per-example
    weight folds W[i, k] / per_subset (f32 numpy, as the JAX batch maker
    does), so stage 1's weighted backward pass is the coded sum of eq. 3."""
    Wn = np.asarray(W, np.float32)
    key = prng.PRNGKey(seed)
    toks, wts = [], []
    for i in range(allocation.num_devices):
        sids = allocation.subsets_of(i)
        rows = [synthetic_lm_batch(prng.fold_in(key, int(k)), step,
                                   per_subset, seq_len, vocab) for k in sids]
        toks.append(torch.cat(rows, 0))
        w = np.repeat(Wn[i, sids] / per_subset, per_subset)
        wts.append(torch.from_numpy(w.astype(np.float32)))
    return torch.stack(toks), torch.stack(wts)
