"""Carry parameters and serving caches between the JAX package and the
port.

`params_from_jax` takes a JAX param tree already converted to numpy
(nested dicts of arrays, e.g. `jax.tree.map(np.asarray, params)`) and
returns the port's state dict: '/'-joined key paths -> torch tensors of the
same shapes.  `params_to_jax` is the inverse.  `caches_from_jax` and
`caches_to_jax` carry a serving cache tree (nested dicts and tuples, as
JAX's `init_caches` / `prefill` build them for every family) with its
nesting kept.  None of them imports JAX.

bfloat16 crosses through a 16-bit view: JAX hands bf16 over as numpy
arrays of ml_dtypes' `bfloat16`, which `torch.from_numpy` refuses.  The
port does not import ml_dtypes; `params_to_jax` finds numpy's `bfloat16`
by name, which exists once ml_dtypes is loaded (JAX loads it).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "caches_from_jax",
           "caches_to_jax"]


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
