"""Deterministic synthetic LM batches for the coded train step (port of
`repro.data.pipeline`: synthetic_lm_batch and coded_train_batch).

Same distribution as the JAX pipeline — Zipf-ish unigrams by inverse CDF on
exponential ranks, then a copy-previous-token perturbation with probability
0.25 — drawn from an explicit `torch.Generator`, so the bits differ from
JAX's.  A generator is seeded from (seed, subset, step), so every rank that
holds subset k regenerates the identical rows without coordination.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.coding import Allocation

__all__ = ["generator_for", "synthetic_lm_batch", "coded_train_batch"]


def generator_for(*words: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of non-negative ints."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(1,
                                                                 np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def synthetic_lm_batch(gen: torch.Generator, batch: int, seq_len: int,
                       vocab: int) -> torch.Tensor:
    """(batch, seq_len+1) int64 tokens drawn from `gen` (CPU)."""
    u = torch.rand((batch, seq_len + 1), generator=gen) * (1.0 - 1e-6) + 1e-6
    ranks = torch.floor(torch.exp(u * math.log(float(vocab)))) - 1.0
    toks = ranks.to(torch.int64).clamp(0, vocab - 1)
    copy = torch.rand(toks.shape, generator=gen) < 0.25
    return torch.where(copy, torch.roll(toks, 1, dims=-1), toks)


def coded_train_batch(seed: int, step: int, allocation: Allocation,
                      W: np.ndarray, per_subset: int, seq_len: int,
                      vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One global coded batch: (tokens (N, b_loc, L+1) int64, weights
    (N, b_loc) f32).  Rank i's rows are its subsets' rows; the per-example
    weight folds W[i, k] / per_subset (f32 numpy, as the JAX batch maker
    does), so stage 1's weighted backward pass is the coded sum of eq. 3."""
    Wn = np.asarray(W, np.float32)
    toks, wts = [], []
    for i in range(allocation.num_devices):
        sids = allocation.subsets_of(i)
        rows = [synthetic_lm_batch(generator_for(seed, int(k), step),
                                   per_subset, seq_len, vocab) for k in sids]
        toks.append(torch.cat(rows, 0))
        w = np.repeat(Wn[i, sids] / per_subset, per_subset)
        wts.append(torch.from_numpy(w.astype(np.float32)))
    return torch.stack(toks), torch.stack(wts)
