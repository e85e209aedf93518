"""PlanSpec: one frozen, serialisable record of a (d, wire, k, buckets)
deployment (port of `repro.core.plan`).

  plan.wire(n, nd)          -> the wire actually shipped
  plan.rank_wire_bytes(n)   -> per-rank uplink bytes (what StepTimer prices)

`launch.train.TrainRun(plan=...)` runs one.  The JSON form is JAX's
`repro.plan/v1` to the key, so a plan file saved by either package loads
in the other to an equal record.  `backend` is kept for that file format
only: the port picks its kernels by the tensors' device.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from .collectives import Wire, build_wire

__all__ = ["PlanSpec", "build_wire", "PLAN_SCHEMA", "ALLOCATIONS",
           "PLAN_COMPRESSORS", "BUCKET_SCHEDULES", "PLAN_BACKENDS"]

PLAN_SCHEMA = "repro.plan/v1"
ALLOCATIONS = ("uniform", "rate_aware", "exact_load")
PLAN_COMPRESSORS = ("sign", "block_topk", "topk", "identity")
BUCKET_SCHEDULES = ("serial", "pipelined")
PLAN_BACKENDS = ("auto", "pallas", "jnp")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """One deployment configuration of the coded-compressed trainer.

    `num_ranks` (the coding-rank count) may be left unset when the plan is
    written (the launcher binds it); when set, a per-rank `k_per_block`
    tuple of the wrong length fails at construction.
    """

    d: int = 2                          # redundancy (copies per data shard)
    allocation: str = "uniform"         # uniform | rate_aware | exact_load
    compressor: str = "sign"            # sign | block_topk | topk | identity
    group_size: int = 512               # sign group (also phase-2 packing)
    k_per_block: Union[int, Tuple[int, ...]] = 8
    # ^ kept coords per block (block_topk); a per-rank tuple is a per-rank
    #   k budget (sim.cost_model.solve_k_budgets output)
    block_size: int = 256               # sparsification block (block_topk)
    topk_k: int = 64                    # global-K budget (compressor="topk")
    value_dtype: str = "float32"        # sparse values / dense payload dtype
    num_buckets: int = 1                # flat-vector split
    bucket_schedule: str = "pipelined"  # pipelined | serial
    backend: str = "auto"               # JAX's kernel dispatch (file only)
    num_ranks: Optional[int] = None     # coding-rank count (None = unbound)

    def __post_init__(self):
        if isinstance(self.k_per_block, (list, tuple)):
            ks = tuple(self.k_per_block)
            if any(int(k) != k for k in ks):
                raise ValueError(f"per-rank k budgets must be integers, "
                                 f"got {ks}")
            object.__setattr__(self, "k_per_block",
                               tuple(int(k) for k in ks))
        if self.d < 1:
            raise ValueError(f"redundancy d must be >= 1, got {self.d}")
        if self.allocation not in ALLOCATIONS:
            raise ValueError(f"unknown allocation {self.allocation!r}; "
                             f"have {ALLOCATIONS}")
        if self.compressor not in PLAN_COMPRESSORS:
            raise ValueError(f"unknown compressor {self.compressor!r}; "
                             f"have {PLAN_COMPRESSORS}")
        if self.group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {self.group_size}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.topk_k < 1:
            raise ValueError(f"topk_k must be >= 1, got {self.topk_k}")
        if self.num_buckets < 1:
            raise ValueError(f"num_buckets must be >= 1, "
                             f"got {self.num_buckets}")
        if self.bucket_schedule not in BUCKET_SCHEDULES:
            raise ValueError(f"unknown bucket_schedule "
                             f"{self.bucket_schedule!r}; "
                             f"have {BUCKET_SCHEDULES}")
        if self.backend not in PLAN_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"have {PLAN_BACKENDS}")
        if self.num_ranks is not None and self.num_ranks < 1:
            raise ValueError(f"num_ranks must be >= 1, got {self.num_ranks}")
        if self.num_ranks is not None and self.d > self.num_ranks:
            raise ValueError(f"redundancy d={self.d} exceeds the coding-rank "
                             f"count num_ranks={self.num_ranks}")
        if isinstance(self.k_per_block, tuple):
            if self.compressor != "block_topk":
                raise ValueError("per-rank k budgets (tuple k_per_block) "
                                 "require compressor='block_topk', got "
                                 f"{self.compressor!r}")
            if not self.k_per_block:
                raise ValueError("per-rank k budgets must be non-empty")
            if any(k < 1 for k in self.k_per_block):
                raise ValueError(f"per-rank k budgets must be ints >= 1, "
                                 f"got {self.k_per_block}")
            if (self.num_ranks is not None
                    and len(self.k_per_block) != self.num_ranks):
                raise ValueError(
                    f"per-rank k budgets have {len(self.k_per_block)} "
                    f"entries but the plan targets num_ranks="
                    f"{self.num_ranks} coding ranks; pass one k per rank")
        elif self.k_per_block < 1:
            raise ValueError(f"k_per_block must be >= 1, "
                             f"got {self.k_per_block}")

    # -- derivation ---------------------------------------------------------

    def wire(self, n: int = 0, nd: int = 1) -> Wire:
        """The wire this plan ships for one bucket of `n` coords."""
        return build_wire(self.compressor, group_size=self.group_size,
                          k_per_block=self.k_per_block,
                          block_size=self.block_size, topk_k=self.topk_k,
                          value_dtype=self.value_dtype, n=n, nd=nd,
                          num_buckets=self.num_buckets)

    def rank_wire_bytes(self, n: int,
                        num_ranks: Optional[int] = None) -> np.ndarray:
        """Per-rank phase-1 uplink bytes for an `n`-coord flat vector."""
        m = num_ranks if num_ranks is not None else self.num_ranks
        if m is None:
            raise ValueError("rank_wire_bytes needs num_ranks (pass it or "
                             "set PlanSpec.num_ranks)")
        return self.wire(n, 1).rank_wire_bytes(n, m)

    @property
    def pad_multiple(self) -> int:
        """Per-bucket flat-size alignment (as `CocoEFConfig`)."""
        if self.compressor == "block_topk":
            return math.lcm(self.group_size, self.block_size)
        return self.group_size

    @property
    def overlap(self) -> bool:
        """Whether StepTimer should price the pipelined bucket overlap."""
        return self.bucket_schedule == "pipelined" and self.num_buckets > 1

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if isinstance(d["k_per_block"], tuple):
            d["k_per_block"] = list(d["k_per_block"])
        return {"schema": PLAN_SCHEMA, **d}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "PlanSpec":
        obj = dict(obj)
        schema = obj.pop("schema", PLAN_SCHEMA)
        if schema != PLAN_SCHEMA:
            raise ValueError(f"unknown plan schema {schema!r}; "
                             f"expected {PLAN_SCHEMA!r}")
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - names
        if unknown:
            raise ValueError(f"unknown PlanSpec fields {sorted(unknown)}")
        if isinstance(obj.get("k_per_block"), list):
            obj["k_per_block"] = tuple(int(k) for k in obj["k_per_block"])
        return cls(**obj)

    @classmethod
    def from_json(cls, text: str) -> "PlanSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2) + "\n")

    @classmethod
    def load(cls, path: str) -> "PlanSpec":
        with open(path) as f:
            return cls.from_json(f.read())
