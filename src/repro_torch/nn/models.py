"""Public model facade (port of `repro.nn.models.Model`, every family):
training loss, and serving (caches, prefill, decode)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.cocoef import FlatLayout, flat_layout
from repro_torch.kernels.ref import wire_dtype
from . import transformer as T
from .config import ModelConfig

__all__ = ["Model"]


class Model:
    """A model whose parameters and gradients live in two padded flat
    buffers of cfg.param_dtype (f32 or bf16) on `device` (`theta`,
    `grad`), laid out as JAX flattens its param tree and padded to a
    multiple of chunk_ranks * group_size * num_buckets.  A bf16 theta has
    a bf16 gradient, as autograd (and JAX) give a bf16 leaf; the train
    step reads it widened to f32 (JAX's `flatten_local`).
    `with_grad=False` (serving) allocates no gradient buffer: `grad` is
    then None."""

    def __init__(self, cfg: ModelConfig, chunk_ranks: int = 1,
                 group_size: int = 512, device="cuda",
                 with_grad: bool = True, num_buckets: int = 1):
        dev = resolve_device(device)
        self.cfg = cfg
        self.layout: FlatLayout = flat_layout(T.param_shapes(cfg),
                                              chunk_ranks, group_size,
                                              num_buckets)
        theta = torch.zeros(self.layout.padded,
                            dtype=wire_dtype(cfg.param_dtype), device=dev)
        grad = torch.zeros_like(theta) if with_grad else None
        self.net = T.Transformer(cfg, self.layout, theta, grad)

    @property
    def theta(self) -> torch.Tensor:
        return self.net.theta

    @property
    def grad(self) -> Optional[torch.Tensor]:
        return self.net.grad

    def params(self) -> Dict[str, torch.Tensor]:
        """name -> view of theta in the JAX shape (the state dict)."""
        return self.net.stacked

    def grads(self) -> Dict[str, torch.Tensor]:
        if self.net.grad is None:
            raise ValueError("this Model was built with_grad=False")
        return self.layout.views(self.net.grad)

    @torch.no_grad()
    def load_params(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy a state dict (e.g. from `convert.params_from_jax`) into
        theta; the padding stays zero."""
        views = self.params()
        if set(state) != set(views):
            raise KeyError(f"state dict keys differ: missing "
                           f"{sorted(set(views) - set(state))}, extra "
                           f"{sorted(set(state) - set(views))}")
        for name, v in views.items():
            v.copy_(state[name])

    def init_(self, seed) -> None:
        """theta = JAX's `init_params(PRNGKey(seed))` (or of a (2,) uint32
        key), drawn on theta's device (`Transformer.init_`)."""
        key = (np.asarray(seed, np.uint32) if np.ndim(seed) == 1
               else prng.PRNGKey(seed))
        self.net.init_(key)

    def loss(self, inputs: torch.Tensor, weights: torch.Tensor,
             targets: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, per_example) of a batch: tokens (B, S+1), or with the
        embeddings input (B, S, d) and its targets (B, S)."""
        return self.net.weighted_loss(inputs, weights, targets)

    # ---- serving ---------------------------------------------------------
    def init_caches(self, batch: int, cache_len: int, dtype=torch.bfloat16):
        return T.init_caches(self.cfg, batch, cache_len, dtype,
                             self.theta.device)

    def prefill(self, inputs: torch.Tensor, cache_dtype=torch.bfloat16):
        return self.net.prefill(inputs, cache_dtype)

    def decode_step(self, caches, inputs: torch.Tensor, pos: int):
        return self.net.decode_step(caches, inputs, pos)
