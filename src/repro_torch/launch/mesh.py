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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshLayout", "make_production_mesh", "make_host_mesh",
           "CodingGrid", "coding_grid", "dry_grid"]


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
