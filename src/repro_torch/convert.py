"""Carry parameters between the JAX package and the port.

`params_from_jax` takes a JAX param tree already converted to numpy
(nested dicts of arrays, e.g. `jax.tree.map(np.asarray, params)`) and
returns the port's state dict: '/'-joined key paths -> torch tensors of the
same shapes.  `params_to_jax` is the inverse.  Neither imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax"]


def params_from_jax(tree: Dict[str, Any], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(params_from_jax(v, name))
        else:
            out[name] = torch.from_numpy(np.array(v, copy=True))
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return tree
