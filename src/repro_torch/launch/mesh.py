"""JAX's meshes as layouts, and the coding grid as `torch.distributed`
process groups (port of `repro.launch.mesh` and of the coding axes of
`repro.core.collectives`).

`MeshLayout` is a mesh's axis names and shape, with no devices: what
`sharding.rules` and the dry run (`launch.dryrun`) read.
`make_production_mesh` gives JAX's two production meshes, (data=16,
model=16) and (pod=2, data=16, model=16); `make_host_mesh` the (data,
model) mesh over the processes or cards there are.

JAX spreads the N coding ranks over mesh axes, the last of which is the
chunk axis of the all_to_all and the all_gather; any axis before it is an
outer axis, reduced after the decode (`collectives.py:571-577`).  Here each
process is one coding rank.  The grid is outer x chunk, the chunk axis
last, with the ranks in row-major order: process r sits at
(r // nd, r % nd).  Every process holds

  chunk_group   the nd ranks that share its outer index (its all_to_all
                and all_gather),
  outer_group   the ranks that share its chunk index (the outer sum; None
                on a 1-D grid).

`torch.distributed` must be initialised first, with the world size the
grid's size; every process calls `coding_grid` with the same shape,
because `new_group` is collective.

`DeviceMesh` is a mesh with devices, for the sharded serve: a layout, the
device indices (row-major over the axes) that this process holds, and its
groups.  It comes in two forms that run one code path:

  in-process  `local_mesh(layout, device)`: one process holds every
              device's shard, all on `device` (the card's machine has one
              card, and NCCL takes one rank a card);
  process     `process_mesh(layout)`: one device a process over the
              initialised default group, its axis groups made with
              `new_group` in one order, as `coding_grid` makes its own.

Every sharded op loops over the devices the process holds, and each
collective takes the list of their contributions and returns every
device's result: `gather` gives each device its axis group's parts in
axis order (gloo moves them as bytes), and `sum_ordered` adds them in
that order from +0 in f32 (or wider), rounded once to the parts' dtype,
so no float sum is left to gloo or NCCL and both forms give the same bits.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.sharding import rules

__all__ = ["MeshLayout", "make_production_mesh", "make_host_mesh",
           "CodingGrid", "coding_grid", "dry_grid", "DeviceMesh",
           "local_mesh", "process_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh without devices: its axis names and their sizes."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape) or \
                min(self.shape, default=1) < 1:
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} do not match")

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """Single pod: (data=16, model=16), 256 devices.  Multi-pod: (pod=2,
    data=16, model=16), 512 devices."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_host_mesh(model_parallel: int = 1) -> MeshLayout:
    """(data, model) over the devices there are: the world size of the
    initialised process group, else the cards, else 1."""
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
    else:
        n = max(torch.cuda.device_count(), 1)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n} devices")
    return MeshLayout(("data", "model"), (n // model_parallel,
                                          model_parallel))


@dataclasses.dataclass(frozen=True)
class CodingGrid:
    """This process's place on the coding grid and its two groups."""

    shape: Tuple[int, ...]          # (nd,) or (n_outer, nd)
    rank: int                       # row-major coding rank
    chunk_group: object
    outer_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.nd * self.n_outer

    @property
    def nd(self) -> int:
        """Ranks on the chunk axis: the all_to_all chunk count."""
        return self.shape[-1]

    @property
    def n_outer(self) -> int:
        return self.shape[0] if len(self.shape) == 2 else 1

    @property
    def outer_index(self) -> int:
        return self.rank // self.nd

    @property
    def chunk_index(self) -> int:
        return self.rank % self.nd


def coding_grid(shape: Sequence[int]) -> CodingGrid:
    """The grid of `shape` ((nd,) or (n_outer, nd)) over the initialised
    default process group, whose size must be prod(shape)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (1, 2) or min(shape) < 1:
        raise ValueError(f"the coding grid is (nd,) or (n_outer, nd), got "
                         f"{shape}")
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed before building "
                           "the coding grid")
    size = shape[0] * (shape[1] if len(shape) == 2 else 1)
    if dist.get_world_size() != size:
        raise ValueError(f"grid {shape} needs {size} processes, the world "
                         f"has {dist.get_world_size()}")
    rank = dist.get_rank()
    if len(shape) == 1:
        return CodingGrid(shape, rank, dist.group.WORLD)
    n_outer, nd = shape
    chunk = outer = None
    for o in range(n_outer):           # every process makes every group,
        g = dist.new_group([o * nd + j for j in range(nd)])   # in one order
        if o == rank // nd:
            chunk = g
    for j in range(nd):
        g = dist.new_group([o * nd + j for o in range(n_outer)])
        if j == rank % nd:
            outer = g
    return CodingGrid(shape, rank, chunk, outer)


def dry_grid(shape: Sequence[int], rank: int = 0) -> CodingGrid:
    """Rank `rank` of a coding grid of `shape` whose groups are
    `core.collectives.DryGroup`s sharing one `calls` list (the grid's
    `chunk_group.calls`): the group form of the collective runs on it
    without a process group, moving nothing and recording its traffic."""
    from repro_torch.core.collectives import DryGroup
    shape = tuple(int(s) for s in shape)
    chunk = DryGroup(shape[-1], "chunk")
    outer = (DryGroup(shape[0], "outer", chunk.calls)
             if len(shape) == 2 else None)
    return CodingGrid(shape, rank, chunk, outer)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A mesh of devices (see the module docstring): `layout`, the device
    `indices` this process holds, the torch `device` their shards live on,
    and, in the process form, this process's group of each axis of size
    above 1 (`groups`; empty in-process)."""

    layout: MeshLayout
    indices: Tuple[int, ...]
    device: torch.device
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def in_process(self) -> bool:
        return len(self.indices) == self.layout.size

    def size(self, axis: str) -> int:
        return self.layout.axis_sizes.get(axis, 1)

    def coords(self, index: int) -> Dict[str, int]:
        """The axis coordinates of device `index` (row-major)."""
        return rules.device_coords(self.layout, index)

    def index_of(self, coords: Dict[str, int]) -> int:
        index = 0
        for name, n in zip(self.layout.axis_names, self.layout.shape):
            index = index * n + coords.get(name, 0)
        return index

    def peers(self, index: int, axis: str) -> List[int]:
        """The devices that share every coordinate of `index` but
        `axis`'s, in `axis` order (`index` among them)."""
        c = self.coords(index)
        return [self.index_of({**c, axis: j}) for j in range(self.size(axis))]

    def gather(self, parts: Sequence[torch.Tensor], axis: str
               ) -> List[List[torch.Tensor]]:
        """parts: one tensor a local device (in `indices` order), of one
        shape and dtype along each axis group.  Returns, for each local
        device, its axis group's parts in `axis` order (in-process the
        tensors themselves; over processes copies moved as bytes)."""
        if len(parts) != len(self.indices):
            raise ValueError(f"{len(parts)} parts for {len(self.indices)} "
                             f"devices")
        if self.in_process:
            by = dict(zip(self.indices, parts))
            return [[by[j] for j in self.peers(i, axis)]
                    for i in self.indices]
        out = []
        for p in parts:
            if self.size(axis) == 1:
                out.append([p])
                continue
            p = p.contiguous()
            got = [torch.empty_like(p) for _ in range(self.size(axis))]
            dist.all_gather([g.reshape(-1).view(torch.uint8) for g in got],
                            p.reshape(-1).view(torch.uint8),
                            group=self.groups[axis])
            out.append(got)
        return out

    def sum_ordered(self, parts: Sequence[torch.Tensor], axis: str
                    ) -> List[torch.Tensor]:
        """Each local device's sum over its `axis` group: the gathered
        parts added in `axis` order into +0 in f32 (f64 stays f64), then
        rounded once to the parts' dtype.  In-process the devices of one
        group share the result."""
        sums: Dict[Tuple[int, ...], torch.Tensor] = {}
        out = []
        for group in self.gather(parts, axis):
            key = tuple(id(t) for t in group)
            if key not in sums:
                dt = group[0].dtype
                acc = torch.zeros(group[0].shape, device=group[0].device,
                                  dtype=torch.promote_types(dt,
                                                            torch.float32))
                for t in group:
                    acc.add_(t)
                sums[key] = acc.to(dt)
            out.append(sums[key])
        return out

    def all_parts(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every device's part in device order (over processes: gathered
        from the world as bytes; the parts must share a shape)."""
        if self.in_process:
            by = dict(zip(self.indices, parts))
            return [by[i] for i in range(self.layout.size)]
        (p,) = parts
        p = p.contiguous()
        got = [torch.empty_like(p) for _ in range(self.layout.size)]
        dist.all_gather([g.reshape(-1).view(torch.uint8) for g in got],
                        p.reshape(-1).view(torch.uint8))
        return got


def local_mesh(layout: MeshLayout, device="cuda") -> DeviceMesh:
    """The in-process mesh: this process holds every device of `layout`,
    each device's shards on `device`."""
    return DeviceMesh(layout, tuple(range(layout.size)),
                      resolve_device(device))


def process_mesh(layout: MeshLayout, device=None) -> DeviceMesh:
    """The process mesh over the initialised default group, whose world
    size must be layout.size: process r holds device r.  Every process
    makes every axis line's group, in one order (`new_group` is
    collective).  device: this process's device (default: the CPU on
    gloo, else its card, cuda:<rank % cards>)."""
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed before building "
                           "the process mesh")
    if dist.get_world_size() != layout.size:
        raise ValueError(f"mesh {layout.shape} needs {layout.size} "
                         f"processes, the world has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    if device is None:
        device = ("cpu" if dist.get_backend() == "gloo" else
                  f"cuda:{rank % max(torch.cuda.device_count(), 1)}")
    mesh = DeviceMesh(layout, (rank,), resolve_device(device))
    groups = {}
    for a, (name, n) in enumerate(zip(layout.axis_names, layout.shape)):
        if n == 1:
            continue
        others = [range(m) for b, m in enumerate(layout.shape) if b != a]
        for rest in itertools.product(*others):
            c = dict(zip([x for b, x in enumerate(layout.axis_names)
                          if b != a], rest))
            ranks = [mesh.index_of({**c, name: j}) for j in range(n)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    return DeviceMesh(layout, (rank,), mesh.device, groups)
