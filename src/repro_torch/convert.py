"""Carry parameters and serving caches between the JAX package and the
port.

`params_from_jax` takes a JAX param tree already converted to numpy
(nested dicts of arrays, e.g. `jax.tree.map(np.asarray, params)`) and
returns the port's state dict: '/'-joined key paths -> torch tensors of the
same shapes.  `params_to_jax` is the inverse.  `caches_from_jax` and
`caches_to_jax` carry a serving cache tree (nested dicts and tuples, as
JAX's `init_caches` / `prefill` build them for every family) with its
nesting kept.  None of them imports JAX.

For the sharded serve, `params_to_shards` cuts a whole state dict (the
port's, or JAX's numpy tree) into each device's shard on a mesh layout
(`sharding.rules.param_specs`), and `caches_to_shards` /
`caches_from_shards` carry the dense family's serve caches between the
whole tree and each device's blocks in the port's ring layout
(`rules.serve_cache_specs`).

bfloat16 crosses through a 16-bit view: JAX hands bf16 over as numpy
arrays of ml_dtypes' `bfloat16`, which `torch.from_numpy` refuses.  The
port does not import ml_dtypes; `params_to_jax` finds numpy's `bfloat16`
by name, which exists once ml_dtypes is loaded (JAX loads it).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "caches_from_jax",
           "caches_to_jax", "params_to_shards", "caches_to_shards",
           "caches_from_shards"]


def params_from_jax(tree: Dict[str, Any], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(params_from_jax(v, name))
        else:
            out[name] = _to_torch(np.array(v, copy=True))
    return out


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16")).copy()
    return t.numpy().copy()


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = _to_numpy(t)
    return tree


def caches_from_jax(tree):
    """A JAX cache tree (dicts, tuples and lists of numpy-convertible
    arrays) -> the same nesting of torch tensors (lists become tuples, as
    the port's trees are), every bit kept."""
    if isinstance(tree, dict):
        return {k: caches_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(caches_from_jax(v) for v in tree)
    return _to_torch(np.array(tree, copy=True))


def caches_to_jax(tree):
    """The port's cache tree -> the same nesting of numpy arrays (bf16 as
    numpy's `bfloat16`), for `jnp.asarray`."""
    if isinstance(tree, dict):
        return {k: caches_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(caches_to_jax(v) for v in tree)
    return _to_numpy(tree)


def params_to_shards(state: Dict[str, Any], cfg, layout, indices=None
                     ) -> List[Dict[str, torch.Tensor]]:
    """Each device's shard of a whole state dict on the mesh `layout`
    (a `launch.mesh.MeshLayout`; `indices`: the devices, default every
    one), as views of `state`'s tensors: name -> block
    (`rules.shard_of` by `rules.param_specs`).  `state` is the port's
    (name -> tensor, e.g. `Model.params()`) or JAX's nested numpy tree
    (through `params_from_jax`)."""
    from repro_torch.nn.transformer import param_shapes
    from repro_torch.sharding import rules
    if any(isinstance(v, dict) for v in state.values()):
        state = params_from_jax(state)
    specs = rules.param_specs(param_shapes(cfg), cfg, layout)
    indices = range(layout.size) if indices is None else indices
    return [{n: rules.shard_of(t, specs[n], layout, i)
             for n, t in state.items()} for i in indices]


def _cache_specs(tree, cfg, layout, batch: int):
    from repro_torch.sharding import rules
    return rules.serve_cache_specs(tree, cfg, layout,
                                   rules.batch_axes(layout, batch), batch)


def caches_to_shards(tree, cfg, layout, batch: int) -> list:
    """Every device's blocks (views) of a whole dense-family cache tree
    of global batch `batch`, in device order."""
    from repro_torch.nn.transformer import tree_map
    from repro_torch.sharding import rules
    specs = _cache_specs(tree, cfg, layout, batch)
    return [tree_map(lambda t, s, i=i: rules.shard_of(t, s, layout, i),
                     tree, specs) for i in range(layout.size)]


def caches_from_shards(parts: list, cfg, layout, batch: int):
    """The whole cache tree from every device's blocks (`parts`, in
    device order): the inverse of `caches_to_shards`."""
    from repro_torch.nn.transformer import tree_map
    from repro_torch.sharding import rules
    specs = _cache_specs(parts[0], cfg, layout, batch)
    return tree_map(lambda p, s, *ps: rules.unshard((p,) + ps, s, layout),
                    parts[0], specs, *parts[1:])
