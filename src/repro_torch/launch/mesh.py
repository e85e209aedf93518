"""The coding grid as `torch.distributed` process groups (port of the
coding axes of `repro.core.collectives` and `repro.launch.mesh`).

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
from typing import Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["CodingGrid", "coding_grid"]


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
