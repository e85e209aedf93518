"""The paper's experimental tasks as grad_fn factories (port of
`repro.data.tasks`: Task A, the linear regression of Sec. V.A).

`linreg_task` returns (grad_fn, loss_fn, theta0, extras) with
  grad_fn(theta) -> (M, D) per-subset gradients (feeds eq. 3)
  loss_fn(theta) -> F(theta) = sum_k f_k(theta), a float
drawn from the same `np.random.default_rng(seed)` stream as JAX's, so Z,
y and theta0 are bit-identical.  f_k(theta) = 0.5 (<theta, z_k> - y_k)^2
with z_k ~ N(0, 100) in R^D and y_k ~ N(<z_k, theta_hat>, 1).

The dot products <theta, z_k> are summed as a fixed binary tree of
rounded f32 adds (the products, zero-padded to a power of two, halved
until one is left): the same bits on the CPU and on the card, so the
reference loop on either device gives the same trajectory.  JAX's
`Z @ theta` sums in XLA's order, so free-running trajectories of the two
packages agree within a tolerance (tests/test_torch_reference.py).

Task B (classification_task, the small CNN) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["linreg_task"]


def _tree_dot(Z: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(M,) f32: row k is sum_j Z[k, j] * theta[j], the products rounded
    to f32 and summed pairwise in a fixed binary tree."""
    x = Z * theta
    width = 1 << max(0, (x.shape[1] - 1).bit_length())
    if width != x.shape[1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def linreg_task(seed: int = 0, num_subsets: int = 100, dim: int = 100,
                device="cuda") -> Tuple[Callable, Callable, torch.Tensor,
                                        Dict[str, torch.Tensor]]:
    """Sec. V.A synthetic linear regression on `device`."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(0.0, 10.0, size=(num_subsets, dim))
    theta_hat = rng.normal(0.0, 1.0, size=(dim,))
    y = Z @ theta_hat + rng.normal(0.0, 1.0, size=(num_subsets,))
    theta0 = rng.normal(0.0, 1.0, size=(dim,))

    dev = torch.device(device)
    Zt = torch.from_numpy(Z.astype(np.float32)).to(dev)
    yt = torch.from_numpy(y.astype(np.float32)).to(dev)

    def grad_fn(theta: torch.Tensor) -> torch.Tensor:
        resid = _tree_dot(Zt, theta) - yt                    # (M,)
        return resid[:, None] * Zt                           # (M, D)

    def loss_fn(theta: torch.Tensor) -> float:
        resid = (_tree_dot(Zt, theta) - yt).double()
        return float(0.5 * (resid * resid).sum())

    return (grad_fn, loss_fn,
            torch.from_numpy(theta0.astype(np.float32)).to(dev),
            {"Z": Zt, "y": yt})
