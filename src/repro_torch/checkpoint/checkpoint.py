"""Checkpoints of (params, error vectors) in the JAX package's on-disk
format (port of `repro.checkpoint.checkpoint`), so a checkpoint written by
either package restores in the other.

File `ckpt_%010d.rpr`:

  b"RPR1"  <QQ: header bytes, payload bytes>  header (JSON)  payload

The header is {"step", "trees", "codec", "extra"}; trees[name] holds the
tree's leaves ({"shape", "dtype"} each), their byte offsets in the
uncompressed payload, and JAX's treedef string.  The payload is every
leaf's bytes in order, tree after tree, compressed with zstd when the
`zstandard` package imports (as JAX does), raw otherwise.  The file is
written to a temporary name and renamed, so a crash mid-write never leaves
a broken latest checkpoint.

A tree is one tensor (one leaf) or a state dict whose keys are '/'-joined
key paths (`convert.params_from_jax`, `Model.params()`): its leaves go in
JAX's `tree.flatten` order, dict keys sorted level by level.  JAX's train
state keeps e as (data, model, flat) = (N, 1, flat_pad) on a
(data = N, model = 1) mesh; pass the port's (N, flat_pad) error vectors as
`e.view(N, 1, -1)`, the same bytes.

Leaves stream between the file and their tensors a chunk at a time, so a
tensor on the card is never copied whole to host memory and the raw
payload is never joined: the offsets are known before the first byte.
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cocoef import leaf_order

try:  # optional: without it the payload is written raw
    import zstandard
except ModuleNotFoundError:
    zstandard = None

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "elastic_rescale_ef", "MAGIC"]

MAGIC = b"RPR1"
CHUNK = 1 << 26            # elements a leaf moves at a time

Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [tree[k] for k in leaf_order(tree)]


def _treedef(tree: Tree) -> str:
    """JAX's `str(treedef)` of the tree (dict keys sorted, leaves *)."""
    if isinstance(tree, torch.Tensor):
        return "PyTreeDef(*)"
    nested: Dict[str, Any] = {}
    for name in tree:
        *path, leaf = name.split("/")
        node = nested
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = None

    def fmt(node) -> str:
        if node is None:
            return "*"
        return "{" + ", ".join(f"'{k}': {fmt(node[k])}"
                               for k in sorted(node)) + "}"
    return f"PyTreeDef({fmt(nested)})"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host_chunks(t: torch.Tensor):
    """The tensor's bytes as numpy arrays of at most CHUNK elements."""
    flat = t.detach().reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        c = flat[i:i + CHUNK].cpu()
        if c.dtype == torch.bfloat16:
            c = c.view(torch.int16)
        yield c.numpy()


def save_checkpoint(directory: Union[str, Path], step: int,
                    state: Dict[str, Tree],
                    extra: Optional[Dict] = None) -> Path:
    """Write `state` ({name: tree}, e.g. {"params": model.params(), "e":
    e.view(N, 1, -1)}) as the checkpoint of `step`; atomic.  Returns the
    file's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    trees, leaves, off = {}, [], 0
    for name, tree in state.items():
        ls = _leaves(tree)
        meta = {"leaves": [], "treedef": _treedef(tree), "offsets": []}
        for t in ls:
            meta["leaves"].append({"shape": list(t.shape),
                                   "dtype": _dtype_name(t)})
            meta["offsets"].append(off)
            off += t.numel() * t.element_size()
        trees[name] = meta
        leaves += ls
    codec = "zstd" if zstandard is not None else "raw"
    header = json.dumps({"step": int(step), "trees": trees,
                         "codec": codec, "extra": extra or {}}).encode()
    final = directory / f"ckpt_{step:010d}.rpr"
    with tempfile.NamedTemporaryFile(dir=directory, delete=False) as tmp:
        tmp.write(MAGIC)
        tmp.write(struct.pack("<QQ", len(header), 0))
        tmp.write(header)
        start = tmp.tell()
        if codec == "zstd":
            with zstandard.ZstdCompressor(level=3).stream_writer(
                    tmp, size=off, closefd=False) as w:
                for t in leaves:
                    for c in _host_chunks(t):
                        w.write(c)
        else:
            for t in leaves:
                for c in _host_chunks(t):
                    tmp.write(c)
        clen = tmp.tell() - start
        tmp.seek(len(MAGIC))
        tmp.write(struct.pack("<QQ", len(header), clen))
        tmp.flush()
        os.fsync(tmp.fileno())
        tmp_path = tmp.name
    os.replace(tmp_path, final)               # atomic on POSIX
    return final


def latest_step(directory: Union[str, Path]) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.stem.split("_")[1]) for p in directory.glob("ckpt_*.rpr")]
    return max(steps) if steps else None


def _decode(codec: str, blob: bytes) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise ModuleNotFoundError(
                "checkpoint was written with the zstd codec but the "
                "'zstandard' package is not installed; pip install zstandard "
                "to restore it")
        return zstandard.ZstdDecompressor().decompress(blob)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _fill(dst: torch.Tensor, read) -> None:
    """Copy into `dst` chunk by chunk; read(elem_offset, count) gives the
    numpy elements (dst's dtype, bf16 as int16)."""
    flat = dst.detach().view(-1)
    for i in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - i)
        src = torch.from_numpy(read(i, n))
        if dst.dtype == torch.bfloat16:
            src = src.view(torch.bfloat16)
        flat[i:i + n].copy_(src)


@torch.no_grad()
def restore_checkpoint(directory: Union[str, Path],
                       templates: Dict[str, Tree], step: Optional[int] = None
                       ) -> Tuple[int, Dict[str, Tree]]:
    """Read the checkpoint of `step` (default: the latest) into the
    tensors of `templates` ({name: tree}, shaped and typed as saved), in
    place, on whatever device they live.  Returns (step, templates)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = directory / f"ckpt_{step:010d}.rpr"
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: corrupt checkpoint (bad magic)")
        hlen, clen = struct.unpack("<QQ", f.read(16))
        header = json.loads(f.read(hlen))
        start = f.tell()
        codec = header.get("codec", "zstd")
        payload = None if codec == "raw" else _decode(codec, f.read(clen))
        for name, tree in templates.items():
            meta = header["trees"][name]
            ls = _leaves(tree)
            if len(ls) != len(meta["leaves"]):
                raise ValueError(f"{path}: tree {name!r} has "
                                 f"{len(meta['leaves'])} leaves, the "
                                 f"template {len(ls)}")
            for t, lm, off in zip(ls, meta["leaves"], meta["offsets"]):
                if list(t.shape) != lm["shape"] or \
                        _dtype_name(t) != lm["dtype"]:
                    raise ValueError(
                        f"{path}: a leaf of {name!r} is {lm['dtype']} "
                        f"{lm['shape']}, the template "
                        f"{_dtype_name(t)} {list(t.shape)}")
                np_dt = (np.dtype(np.int16) if t.dtype == torch.bfloat16
                         else np.dtype(lm["dtype"]))

                def read(i, n, off=off, np_dt=np_dt):
                    if payload is not None:
                        return np.frombuffer(payload, np_dt, n,
                                             off + i * np_dt.itemsize).copy()
                    f.seek(start + off + i * np_dt.itemsize)
                    buf = np.empty(n, np_dt)
                    if f.readinto(buf.view(np.uint8)) != buf.nbytes:
                        raise ValueError(f"{path}: payload cut short")
                    return buf
                _fill(t, read)
    return header["step"], templates


def elastic_rescale_ef(e_old, mesh_shape_old: Tuple[int, ...],
                       mesh_shape_new: Tuple[int, ...],
                       flat_pad_new: int):
    """Map error vectors (devices..., flat) across a device-count change:
    coding ranks in both grids keep their error vectors (truncated or
    zero-padded to the new flat size), new ranks start at zero.  A numpy
    array gives a numpy array, a torch tensor (a bf16 e of
    TrainRun.ef_dtype included, which numpy cannot hold) a tensor on its
    device; either way of e_old's dtype."""
    if isinstance(e_old, torch.Tensor):
        new = e_old.new_zeros(tuple(mesh_shape_new) + (flat_pad_new,))
    else:
        e_old = np.asarray(e_old)
        new = np.zeros(tuple(mesh_shape_new) + (flat_pad_new,),
                       e_old.dtype)
    old_flat = e_old.shape[-1]
    common = tuple(min(a, b) for a, b in zip(mesh_shape_old, mesh_shape_new))
    sl = tuple(slice(0, c) for c in common)
    m = min(old_flat, flat_pad_new)
    new[sl + (slice(0, m),)] = e_old[sl + (slice(0, m),)]
    return new
