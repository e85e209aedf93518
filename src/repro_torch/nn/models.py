"""Public model facade (port of `repro.nn.models.Model`, every family):
training loss, and serving (caches, prefill, decode); `ShardedModel`, the
shards of θ one process holds of a mesh, for the dense family's sharded
serve."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.cocoef import FlatLayout, flat_layout
from repro_torch.kernels.ref import wire_dtype
from repro_torch.sharding import rules
from . import transformer as T
from .config import ModelConfig
from .layers import BIG_WINDOW

__all__ = ["Model", "ShardedModel"]


class Model:
    """A model whose parameters and gradients live in two padded flat
    buffers of cfg.param_dtype (f32 or bf16) on `device` (`theta`,
    `grad`), laid out as JAX flattens its param tree and padded to a
    multiple of chunk_ranks * group_size * num_buckets.  A bf16 theta has
    a bf16 gradient, as autograd (and JAX) give a bf16 leaf; the train
    step reads it widened to f32 (JAX's `flatten_local`).
    `with_grad=False` (serving) allocates no gradient buffer: `grad` is
    then None.  With a mesh `layout` (`launch.mesh.MeshLayout`), theta
    holds one device's shard of every leaf (`rules.param_specs` on the
    layout, each block contiguous in the flat buffer; `specs` the leaves'
    specs; every device's shard has the same shapes), for the dense
    family's sharded serve (`ShardedModel`); a shard takes no
    gradient."""

    def __init__(self, cfg: ModelConfig, chunk_ranks: int = 1,
                 group_size: int = 512, device="cuda",
                 with_grad: bool = True, num_buckets: int = 1,
                 layout=None):
        dev = resolve_device(device)
        self.cfg = cfg
        shapes = T.param_shapes(cfg)
        self.specs = None
        if layout is not None:
            T.check_sharded(cfg)
            if with_grad:
                raise ValueError("a shard of θ serves only: pass "
                                 "with_grad=False")
            self.specs = rules.param_specs(shapes, cfg, layout)
            shapes = {n: rules.shard_shape(s, self.specs[n], layout)
                      for n, s in shapes.items()}
        self.layout: FlatLayout = flat_layout(shapes, chunk_ranks,
                                              group_size, num_buckets)
        theta = torch.zeros(self.layout.padded,
                            dtype=wire_dtype(cfg.param_dtype), device=dev)
        grad = torch.zeros_like(theta) if with_grad else None
        self.net = T.Transformer(cfg, self.layout, theta, grad, self.specs)

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
        if self.specs is not None:
            raise NotImplementedError("a shard draws no θ0: draw the whole "
                                      "θ0 and cut it (convert."
                                      "params_to_shards)")
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


class ShardedModel:
    """The shards of θ that one process holds of a `launch.mesh.
    DeviceMesh`: `models[j]` the `Model` shard of local device
    mesh.indices[j], on mesh.device.  In-process the devices of one model
    coordinate share one `Model` (θ is replicated over the data axis and
    serving only reads it), so a (data, model) mesh allocates θ once a
    model coordinate.  `prefill` and `decode_step` are the dense stack's
    sharded serve (`transformer.sharded_prefill`, `sharded_decode_step`)
    and run under `sharding.ctx.use_mesh(mesh)`, as `launch.serve`'s
    steps do; they take and return a block a local device."""

    def __init__(self, cfg: ModelConfig, mesh):
        T.check_sharded(cfg)
        self.cfg, self.mesh = cfg, mesh
        by_coord: Dict[int, Model] = {}
        self.models = []
        for i in mesh.indices:
            c = mesh.coords(i).get("model", 0)
            if c not in by_coord:
                by_coord[c] = Model(cfg, device=mesh.device,
                                    with_grad=False, layout=mesh.layout)
            self.models.append(by_coord[c])

    def params(self) -> list:
        """Each local device's state dict of shard views."""
        return [m.params() for m in self.models]

    @torch.no_grad()
    def load_params(self, state) -> None:
        """Cut a whole state dict (the port's, or JAX's numpy tree) into
        each local device's shard (`convert.params_to_shards`)."""
        from repro_torch.convert import params_to_shards
        shards = params_to_shards(state, self.cfg, self.mesh.layout,
                                  self.mesh.indices)
        done = set()
        for m, sh in zip(self.models, shards):
            if id(m) not in done:
                m.load_params(sh)
                done.add(id(m))

    def init_caches(self, batch: int, cache_len: int,
                    dtype=torch.bfloat16) -> list:
        """Each local device's block of `init_caches(batch, cache_len)`
        (batch: the global batch) in the ring layout of `rules.
        serve_cache_specs`."""
        meta = T.init_caches(self.cfg, batch, cache_len, dtype, "meta")
        specs = rules.serve_cache_specs(
            meta, self.cfg, self.mesh.layout,
            rules.batch_axes(self.mesh.layout, batch), batch)

        def block(t, spec):
            shape = rules.shard_shape(t.shape, spec, self.mesh.layout)
            if t.dtype == torch.int32:          # pos: no slot holds one yet
                return torch.full(shape, -BIG_WINDOW, dtype=t.dtype,
                                  device=self.mesh.device)
            return torch.zeros(shape, dtype=t.dtype, device=self.mesh.device)
        return [T.tree_map(block, meta, specs) for _ in self.mesh.indices]

    def prefill(self, inputs: list, cache_dtype=torch.bfloat16):
        return T.sharded_prefill([m.net for m in self.models], inputs,
                                 cache_dtype)

    def decode_step(self, caches: list, inputs: list, pos: int):
        return T.sharded_decode_step([m.net for m in self.models], caches,
                                     inputs, pos)
