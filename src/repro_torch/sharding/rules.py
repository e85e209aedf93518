"""Partition rules: parameter leaf -> spec on a mesh (the port's copy of
`repro.sharding.rules`, on plain tuples in place of `PartitionSpec`).

A spec is a tuple with one entry a dim: None (replicated), an axis name,
or a tuple of two or more axis names (a one-axis tuple is the name, as
`PartitionSpec` keeps it).  Rules are keyed on the last component of a
leaf's '/'-joined name (the port's names are JAX's key paths,
`nn.transformer.param_shapes`) and applied to the *trailing* dims;
leading stack dims (JAX's scanned layer stacks) are padded with None.
`fsdp=True` (qwen1.5-110b) also shards the big matmul weights over the
`data` axis.

Every spec is checked against the mesh: an axis that does not divide its
dim is dropped and, where another replicated dim divides by it, placed
there instead (`_check_divisible`).  The meshes are `launch.mesh.
MeshLayout`s: only the axis names and sizes are read.

The sharded serve reads a device's block of a leaf with `shard_of` and
puts blocks back together with `unshard`; `dp_spec` is the serve batch's
data-parallel axes (JAX's `_dp_spec`); `serve_cache_specs` is the port's
own layout of the KV rings (ROADMAP C17: the KV heads over the model axis
where they and head_dim divide it, else JAX's `cache_specs`, head_dim over
model; the batch over the dp axes on its own dim), whose per-device bytes
are JAX's either way.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.nn.config import ModelConfig

__all__ = ["param_specs", "param_shardings", "grads_specs", "cache_specs",
           "serve_cache_specs", "ring_spec", "kv_heads_split", "dp_spec",
           "batch_axes", "device_coords", "shard_shape", "shard_of",
           "unshard", "local_flat_size", "entry"]

M = "model"
D = "data"

Spec = Tuple[Any, ...]

# (base spec, fsdp spec) per leaf name; specs target the trailing dims
_RULES: Dict[str, Tuple[tuple, tuple]] = {
    # embeddings / head
    "tok_tied": ((M, None), (M, (D,))),           # vocab-sharded (tied)
    "tok": ((None, M), ((D,), M)),                # d-sharded (untied input)
    "head": ((None, M), ((D,), M)),
    "proj": ((None, M), ((D,), M)),
    # attention
    "wq": ((None, M, None), ((D,), M, None)),
    "wk": ((None, M, None), ((D,), M, None)),
    "wv": ((None, M, None), ((D,), M, None)),
    "bq": ((M, None), (M, None)),
    "bk": ((M, None), (M, None)),
    "bv": ((M, None), (M, None)),
    "wo": ((M, None, None), (M, None, (D,))),
    # MLA
    "w_dkv": ((None, None), ((D,), None)),
    "w_uk": ((None, M, None), ((D,), M, None)),
    "w_uv": ((None, M, None), ((D,), M, None)),
    "kv_norm": ((None,), (None,)),
    # MLP (dense + shared experts)
    "w_gate": ((None, M), ((D,), M)),
    "w_up": ((None, M), ((D,), M)),
    "w_down": ((M, None), (M, (D,))),
    # MoE experts (leading expert dim -> EP over model)
    "w_gate_e": ((M, None, None), (M, (D,), None)),
    "w_up_e": ((M, None, None), (M, (D,), None)),
    "w_down_e": ((M, None, None), (M, None, (D,))),
    "router": ((None, None), (None, None)),
    # mamba2
    "w_z": ((None, M), ((D,), M)),
    "w_x": ((None, M), ((D,), M)),
    "w_B": ((None, None), (None, None)),
    "w_C": ((None, None), (None, None)),
    "w_dt": ((None, None), (None, None)),
    "conv_x": ((None, M), (None, M)),
    "conv_bc": ((None, None), (None, None)),
    "conv_b_x": ((M,), (M,)),
    "conv_b_bc": ((None,), (None,)),
    "A_log": ((None,), (None,)),
    "D": ((None,), (None,)),
    "dt_bias": ((None,), (None,)),
    "norm_scale": ((M,), (M,)),
    "w_out": ((M, None), (M, (D,))),
    # xlstm
    "w_xin": ((None, M), ((D,), M)),
    "w_zgate": ((None, M), ((D,), M)),
    "w_q": ((None, None, M), ((D,), None, M)),   # (H, hd, hd) per-head
    "w_k": ((None, None, M), ((D,), None, M)),
    "w_v": ((None, None, M), ((D,), None, M)),
    "w_if": ((None, None), (None, None)),
    "b_if": ((None,), (None,)),
    "w_h": ((None, M), (None, M)),
    # norms
    "scale": ((None,), (None,)),
    "bias": ((None,), (None,)),
    "b": ((None,), (None,)),
}


def _axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry(axes):
    """The spec entry of a dim over `axes` (a name, or a sequence of
    names) as `PartitionSpec` keeps it: None for no axis, the name for
    one, the tuple for more."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _leaf_rule(name: str, shape: Sequence[int], cfg: ModelConfig,
               fsdp: bool) -> Spec:
    keys = name.split("/")
    leaf = keys[-1]
    if leaf == "tok":
        leaf = "tok_tied" if cfg.tie_embeddings else "tok"
    if leaf in ("w_gate", "w_up", "w_down") and "moe" in keys and \
            "shared" not in keys:
        leaf = leaf + "_e"
    nd = len(shape)
    if "slstm" in keys:
        # sLSTM weights are replicated: its sequential per-step matmuls on
        # (B, d) states would make sharded weights a collective a step
        return (None,) * nd
    base, fs = _RULES.get(leaf, ((None,), (None,)))
    spec = tuple(fs if fsdp else base)[-nd:] if nd else ()
    return (None,) * (nd - len(spec)) + spec


def _check_divisible(spec: Spec, shape: Sequence[int],
                     axis_sizes: Dict[str, int]) -> Spec:
    out: List[Any] = []
    dropped: List[str] = []
    for dim, e in zip(shape, spec):
        if e is None:
            out.append(None)
            continue
        axes = _axes(e)
        if dim % math.prod(axis_sizes[a] for a in axes) == 0:
            out.append(e)
        else:
            out.append(None)
            dropped.extend(axes)
    # fallback: re-place dropped axes on another dim that divides (e.g.
    # phi3's 40 heads don't divide model=16 -> shard head_dim=128 instead)
    for ax in dropped:
        sz = axis_sizes[ax]
        for i in range(len(out) - 1, -1, -1):
            if out[i] is not None:
                continue
            if shape[i] % sz == 0 and shape[i] >= sz:
                out[i] = ax
                break
    return tuple(entry(e) for e in out)


def param_specs(shapes: Dict[str, Tuple[int, ...]], cfg: ModelConfig,
                mesh, fsdp: bool = False) -> Dict[str, Spec]:
    """name -> spec of every parameter leaf (`shapes`: name -> shape)."""
    sizes = mesh.axis_sizes
    return {name: _check_divisible(_leaf_rule(name, shape, cfg, fsdp),
                                   shape, sizes)
            for name, shape in shapes.items()}


def param_shardings(shapes: Dict[str, Tuple[int, ...]], cfg: ModelConfig,
                    mesh, fsdp: bool = False
                    ) -> Dict[str, Tuple[Spec, Tuple[int, ...]]]:
    """name -> (spec, one device's shard shape) of every parameter leaf
    (JAX's `NamedSharding`s, as what they say of one device)."""
    return {name: (s, shard_shape(shapes[name], s, mesh))
            for name, s in param_specs(shapes, cfg, mesh, fsdp).items()}


def grads_specs(shapes: Dict[str, Tuple[int, ...]], cfg: ModelConfig,
                mesh, coding_axes: Sequence[str], fsdp: bool = False
                ) -> Dict[str, Spec]:
    """Specs of the per-coding-rank gradient stacks: a leading coding dim
    over the coding axes of the mesh."""
    lead = entry([a for a in coding_axes if a in mesh.axis_names])
    return {name: (lead,) + s
            for name, s in param_specs(shapes, cfg, mesh, fsdp).items()}


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map(fn, t, path + (i,)) for i, t in enumerate(tree))
    return fn(path, tree)


def cache_specs(caches, cfg: ModelConfig, mesh, batch_axes: Sequence[str],
                global_batch: int):
    """Specs of the KV/state caches, a tree of the caches' nesting whose
    leaves have a `.shape`: the batch dim (the first of size
    global_batch) over the dp axes where they divide it, the trailing
    feature dim over model where it divides; `pos` bookkeeping arrays
    stay replicated."""
    sizes = mesh.axis_sizes
    b_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    nb = math.prod(sizes[a] for a in b_axes) if b_axes else 1
    m = sizes.get(M, 1)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: List[Any] = [None] * nd
        if path and path[-1] == "pos":
            return tuple(spec)
        for i, dim in enumerate(shape):
            if dim == global_batch and dim % nb == 0 and nb > 1:
                spec[i] = entry(b_axes)
                break
        if nd >= 2 and shape[-1] % m == 0 and m > 1:
            spec[-1] = M
        return tuple(spec)

    return _map(rule, caches)


def dp_spec(mesh, batch: int):
    """JAX's `_dp_spec`: the largest (pod, data) suffix whose product
    divides the batch, as a spec entry (None: the batch is whole)."""
    sizes = mesh.axis_sizes
    axes = [a for a in ("pod", "data") if a in sizes]
    while axes and batch % math.prod(sizes[a] for a in axes):
        axes.pop(0)
    return entry(axes)


def batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The axes of `dp_spec(mesh, batch)` as a tuple."""
    b = dp_spec(mesh, batch)
    return b if isinstance(b, tuple) else ((b,) if b else ())


def kv_heads_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the sharded serve splits the KV heads over the model axis
    (C17): the query and KV heads and head_dim all divide it, so each
    device attends with its own heads and its ring holds JAX's bytes."""
    m = mesh.axis_sizes.get(M, 1)
    return not (cfg.num_heads % m or cfg.num_kv_heads % m or
                cfg.head_dim % m)


def serve_cache_specs(caches, cfg: ModelConfig, mesh,
                      batch_axes: Sequence[str], global_batch: int):
    """The port's layout of the dense family's serve caches (C17), a tree
    of `caches`' nesting: k and v (L, B, Hkv, T, hd) with the batch over
    `batch_axes` on B and, on a model axis above 1, the KV heads over it
    where `kv_heads_split`, else head_dim where it divides (JAX's
    `cache_specs`, which puts the batch on the first dim of the global
    batch's size: L where L == B); pos replicated.  A device's bytes equal
    JAX's layout's in every case.  Only the leaves' ranks are read, so
    `caches` may hold global or per-device shapes."""
    sizes = mesh.axis_sizes
    b_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    nb = math.prod(sizes[a] for a in b_axes) if b_axes else 1
    b = entry(b_axes) if nb > 1 and global_batch % nb == 0 else None
    ring = ring_spec(cfg, mesh, b)

    def rule(path, leaf):
        if path and path[-1] == "pos":
            return (None,) * len(leaf.shape)
        return ring

    return _map(rule, caches)


def ring_spec(cfg: ModelConfig, mesh, batch=None) -> Spec:
    """The spec of a k or v ring (L, B, Hkv, T, hd) in the port's layout
    (C17), the batch dim laid out by `batch`: on a model axis above 1
    the KV heads over it where `kv_heads_split`, else head_dim where it
    divides."""
    m = mesh.axis_sizes.get(M, 1)
    heads = m > 1 and kv_heads_split(cfg, mesh)
    hd = M if m > 1 and not heads and cfg.head_dim % m == 0 else None
    return (None, batch, M if heads else None, None, hd)


def device_coords(mesh, index: int) -> Dict[str, int]:
    """The axis coordinates of device `index` (row-major over the axes,
    as JAX's mesh devices array)."""
    coords, rest = {}, index
    for name, n in reversed(list(zip(mesh.axis_names, mesh.shape))):
        coords[name] = rest % n
        rest //= n
    return coords


def _blocks(shape: Sequence[int], spec: Spec, mesh, index: int):
    """(start, length) along each dim of device `index`'s block."""
    sizes = mesh.axis_sizes
    coords = device_coords(mesh, index)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, spec):
        if e is None:
            out.append((0, dim))
            continue
        pos = 0
        for a in _axes(e):             # row-major over the entry's axes
            pos = pos * sizes[a] + coords[a]
        n = dim // math.prod(sizes[a] for a in _axes(e))
        out.append((pos * n, n))
    return out


def shard_of(t, spec: Spec, mesh, index: int):
    """Device `index`'s block of the full tensor `t` laid out by `spec`
    (a view: `Tensor.narrow` along each sharded dim; JAX's
    `NamedSharding` places block p of a dim over axes (a, b) at a's
    coordinate * |b| + b's)."""
    shard_shape(t.shape, spec, mesh)            # raises where it does not
    for d, (start, n) in enumerate(_blocks(t.shape, spec, mesh, index)):
        if n != t.shape[d]:
            t = t.narrow(d, start, n)
    return t


def unshard(parts: Sequence[Any], spec: Spec, mesh):
    """The full tensor from every device's block (`parts`, mesh.size of
    them in device order; a replicated block is read from the first
    device that holds it): the inverse of `shard_of`."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size}")
    first = parts[0]
    spec = tuple(spec) + (None,) * (first.dim() - len(spec))
    full_shape = [n * (1 if e is None else
                       math.prod(mesh.axis_sizes[a] for a in _axes(e)))
                  for n, e in zip(first.shape, spec)]
    out = first.new_empty(full_shape)
    seen = set()
    for i, p in enumerate(parts):
        blocks = tuple(_blocks(full_shape, spec, mesh, i))
        if blocks in seen:
            continue
        seen.add(blocks)
        view = out
        for d, (start, n) in enumerate(blocks):
            view = view.narrow(d, start, n)
        view.copy_(p)
    return out


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of a leaf of `shape` laid out by `spec` (JAX's
    `NamedSharding.shard_shape`: each dim over the product of its axes;
    dims past the spec are whole)."""
    sizes = mesh.axis_sizes
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, spec):
        f = 1 if e is None else math.prod(sizes[a] for a in _axes(e))
        if dim % f:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {e} ({f})")
        out.append(dim // f)
    return tuple(out)


def local_flat_size(shapes: Dict[str, Tuple[int, ...]],
                    specs: Dict[str, Spec], mesh) -> int:
    """Elements of one device's local flat: the sum over the leaves of
    their shard sizes (JAX `launch.train._local_flat_size`, which floors
    each dim by its axes' product)."""
    sizes = mesh.axis_sizes
    total = 0
    for name, shape in shapes.items():
        n = 1
        spec = tuple(specs[name]) + (None,) * len(shape)
        for dim, e in zip(shape, spec):
            n *= dim if e is None else \
                dim // math.prod(sizes[a] for a in _axes(e))
        total += n
    return total
