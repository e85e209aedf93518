"""The (N, D) reference loop of Algorithm 1 and its baselines (port of
`repro.core.error_feedback`).

Explicit device-major tensors, line by line as the paper's Algorithm 1:
the oracle of the coded step (`core.cocoef`, `launch.parity`), which must
give the same update bit for bit for the same masks and keys.

  cocoef_step        COCO-EF (biased C + error feedback)
  coco_step          COCO (no error feedback; e untouched)
  unbiased_step      Unbiased (1-bit gradient coding [32] / rand-K)
  unbiased_diff_step Unbiased-diff (gradient-difference compression [23])
  uncompressed_step  SGC [31] (no compression)

The port's arithmetic, where JAX's is XLA's choice:
  - the coded gradients g_i = sum_k W[i, k] grad f_k are summed over the
    subsets in order, each product rounded on its own (JAX: `W @ grads`),
    so the loop gives the same bits on the CPU and on the card;
  - the accumulate gamma*g + e rounds twice (`kernels.ref.mul_add`), as
    the kernels do;
  - the server sum runs over the ranks in order from +0.0 (`_masked_sum`),
    the order of every decode of the coded collective.
Tensors stay on the device of theta; keys are `core/prng.py` keys.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.ref import as_f32, mul_add

from .compression import Compressor

__all__ = ["EFState", "DiffState", "cocoef_step", "coco_step",
           "unbiased_step", "unbiased_diff_step", "uncompressed_step"]

GradFn = Callable[[torch.Tensor], torch.Tensor]   # theta (D,) -> (M, D)


class EFState(NamedTuple):
    """COCO-EF state: theta (D,), error vectors e (N, D)."""

    theta: torch.Tensor
    e: torch.Tensor

    @staticmethod
    def init(theta: torch.Tensor, num_devices: int) -> "EFState":
        return EFState(theta=theta, e=torch.zeros(
            (num_devices,) + tuple(theta.shape), dtype=theta.dtype,
            device=theta.device))


class DiffState(NamedTuple):
    """Gradient-difference state [23]: per-rank references h (N, D) and the
    server's aggregate H = sum_i h_i (D,)."""

    theta: torch.Tensor
    h: torch.Tensor
    H: torch.Tensor

    @staticmethod
    def init(theta: torch.Tensor, num_devices: int) -> "DiffState":
        return DiffState(theta=theta, h=torch.zeros(
            (num_devices,) + tuple(theta.shape), dtype=theta.dtype,
            device=theta.device), H=torch.zeros_like(theta))


def _coded_gradients(grad_fn: GradFn, theta: torch.Tensor,
                     W) -> torch.Tensor:
    """g_i = sum_k W[i, k] grad f_k(theta) (eq. 3), summed over k in order
    from the first product.  W: (N, M).  Returns (N, D)."""
    per_subset = grad_fn(theta)                              # (M, D)
    Wt = torch.as_tensor(np.asarray(W, np.float32)).to(theta.device)
    g = Wt[:, 0:1] * per_subset[0]
    for k in range(1, per_subset.shape[0]):
        g = g + Wt[:, k:k + 1] * per_subset[k]
    return g


def _masked_sum(mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_i mask_i * c_i (eq. 9) over the ranks in order from +0.0, each
    product rounded on its own: the sender order of the coded collective's
    decode, so the loop and the step agree bit for bit."""
    m = mask.to(device=c.device, dtype=c.dtype)
    acc = torch.zeros(c.shape[1:], dtype=c.dtype, device=c.device)
    for i in range(c.shape[0]):
        acc = acc + m[i] * c[i]
    return acc


def _per_device_keys(key: Optional[np.ndarray], step: int, n: int):
    if key is None:
        return None
    return prng.split(prng.fold_in(key, step), n)


def _compress_rows(compressor: Compressor, x: torch.Tensor, keys
                   ) -> torch.Tensor:
    return torch.stack([compressor.apply(x[i], None if keys is None
                                         else keys[i])
                        for i in range(x.shape[0])])


def _keep(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N, 1, ...) bool of the participating ranks."""
    m = mask.to(like.device).reshape((-1,) + (1,) * (like.ndim - 1))
    return m > 0


def cocoef_step(state: EFState, grad_fn: GradFn, W, mask: torch.Tensor,
                gamma, compressor: Compressor, step: int = 0,
                key: Optional[np.ndarray] = None) -> EFState:
    """One iteration of Algorithm 1 (COCO-EF).  mask: (N,) f32 0/1
    straggler indicators I_i^t; gamma a float or a scalar tensor."""
    g = _coded_gradients(grad_fn, state.theta, W)
    acc = mul_add(gamma, g, state.e)                      # eq. (4) argument
    c = _compress_rows(compressor, acc,
                       _per_device_keys(key, step, g.shape[0]))
    ghat = _masked_sum(mask, c)                           # eq. (9)
    theta = state.theta - ghat                            # eq. (10)
    e = torch.where(_keep(mask, acc), acc - c, state.e)   # eq. (7) / frozen
    return EFState(theta=theta, e=e)


def coco_step(state: EFState, grad_fn: GradFn, W, mask: torch.Tensor,
              gamma, compressor: Compressor, step: int = 0,
              key: Optional[np.ndarray] = None) -> EFState:
    """COCO: Algorithm 1 without error feedback (e stays as it is)."""
    g = _coded_gradients(grad_fn, state.theta, W)
    acc = as_f32(gamma, g) * g
    c = _compress_rows(compressor, acc,
                       _per_device_keys(key, step, g.shape[0]))
    return EFState(theta=state.theta - _masked_sum(mask, c), e=state.e)


def unbiased_step(state: EFState, grad_fn: GradFn, W, mask: torch.Tensor,
                  gamma, compressor: Compressor, step: int = 0,
                  key: Optional[np.ndarray] = None) -> EFState:
    """Unbiased baseline [32]: ranks send Q(g_i) with an unbiased Q; the
    server steps theta <- theta - gamma * sum_i I_i Q(g_i)."""
    g = _coded_gradients(grad_fn, state.theta, W)
    q = _compress_rows(compressor, g,
                       _per_device_keys(key, step, g.shape[0]))
    return EFState(theta=state.theta
                   - as_f32(gamma, g) * _masked_sum(mask, q), e=state.e)


def unbiased_diff_step(state: DiffState, grad_fn: GradFn, W,
                       mask: torch.Tensor, gamma, compressor: Compressor,
                       step: int = 0, key: Optional[np.ndarray] = None,
                       alpha: float = 0.1) -> DiffState:
    """Unbiased-diff baseline (DIANA-style [23]) on the coded gradients:
    a live rank sends q_i = Q(g_i - h_i) and sets h_i <- h_i + alpha*q_i;
    the server steps with ghat = H + sum_live q_i and sets
    H <- H + alpha * sum_live q_i (= sum_i h_i)."""
    g = _coded_gradients(grad_fn, state.theta, W)
    q = _compress_rows(compressor, g - state.h,
                       _per_device_keys(key, step, g.shape[0]))
    a = as_f32(alpha, g)
    q_sum = _masked_sum(mask, q)
    theta = state.theta - as_f32(gamma, g) * (state.H + q_sum)
    h = torch.where(_keep(mask, g), state.h + a * q, state.h)
    return DiffState(theta=theta, h=h, H=state.H + a * q_sum)


def uncompressed_step(state: EFState, grad_fn: GradFn, W,
                      mask: torch.Tensor, gamma, step: int = 0) -> EFState:
    """Stochastic gradient coding [31]: dense coded vectors."""
    g = _coded_gradients(grad_fn, state.theta, W)
    return EFState(theta=state.theta
                   - as_f32(gamma, g) * _masked_sum(mask, g), e=state.e)
