"""Wire-aware wall-clock cost model for one coded training step (port of
`repro.sim.cost_model`, all but `ComputeProfile.from_compiled_hlo`).

One step has three legs, each priced from what the runtime ships:

  compute   per-rank local gradient time: base seconds x a per-rank speed
            factor.
  phase 1   each participating rank uplinks `wire.rank_wire_bytes(n)`
            bytes (the port's wires' own accounting); a server fan-in
            serialises ingest into ceil(P / fanin) waves.
  phase 2   the aggregate is broadcast back (n x phase2 itemsize bytes).

The step ends when the server has heard from every participant:

  t_step(mask) = max_{i: mask_i=1} t_comp_i + waves * t_up + t_down .

These are values of a model, not measurements.  Every expression below is
JAX's, in the same float64 order, so `StepTimer` and `solve_k_budgets`
give JAX's numbers bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.collectives import SparseWire, Wire
from repro_torch.kernels import ref

__all__ = ["LinkProfile", "ComputeProfile", "StepTimer", "solve_k_budgets",
           "DEFAULT_LINK", "DEFAULT_COMPUTE"]


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Per-rank link: bandwidth + latency (+ optional server fan-in).

    bandwidth_gbps: nominal uplink Gbit/s per rank (phase-1 payload).
    rank_bandwidth_gbps: optional per-rank uplink Gbit/s overriding the
      nominal value (the setting `solve_k_budgets` targets); () = uniform.
    down_bandwidth_gbps: downlink Gbit/s for the phase-2 broadcast; None =
      same as uplink.
    latency_s: fixed per-message latency (one per leg).
    server_fanin: uplinks the server ingests at once; 0 = unbounded.
    """

    bandwidth_gbps: float = 10.0
    down_bandwidth_gbps: Optional[float] = 100.0
    latency_s: float = 1e-3
    server_fanin: int = 0
    rank_bandwidth_gbps: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.bandwidth_gbps <= 0:
            raise ValueError("uplink bandwidth must be positive")
        if self.rank_bandwidth_gbps and \
                np.any(np.asarray(self.rank_bandwidth_gbps,
                                  np.float64) <= 0):
            raise ValueError("every per-rank uplink bandwidth must be "
                             "positive")

    def up_bandwidths(self, num_ranks: int) -> np.ndarray:
        """(num_ranks,) effective uplink Gbit/s per rank."""
        if not self.rank_bandwidth_gbps:
            return np.full((num_ranks,), self.bandwidth_gbps, np.float64)
        if len(self.rank_bandwidth_gbps) != num_ranks:
            raise ValueError(
                f"link has {len(self.rank_bandwidth_gbps)} per-rank "
                f"bandwidths, asked for {num_ranks} ranks")
        return np.asarray(self.rank_bandwidth_gbps, np.float64)

    def up_s(self, nbytes: int) -> float:
        return self.latency_s + nbytes * 8.0 / (self.bandwidth_gbps * 1e9)

    def up_s_ranks(self, nbytes: Sequence[float]) -> np.ndarray:
        """(num_ranks,) uplink seconds for per-rank payload byte counts."""
        nb = np.asarray(nbytes, np.float64)
        bw = self.up_bandwidths(nb.shape[0])
        return self.latency_s + nb * 8.0 / (bw * 1e9)

    def down_s(self, nbytes: int) -> float:
        bw = self.down_bandwidth_gbps or self.bandwidth_gbps
        return self.latency_s + nbytes * 8.0 / (bw * 1e9)


@dataclasses.dataclass(frozen=True)
class ComputeProfile:
    """Per-rank local-gradient time = base seconds x per-rank speed factor.

    grad_s: base seconds for one local coded gradient.
    speed_factors: per-rank multiplier (>= 1 = slower rank); () = all 1.0.
    """

    grad_s: float = 5e-3
    speed_factors: Tuple[float, ...] = ()

    @classmethod
    def from_flops(cls, flops_per_step: float, device_flops: float = 1e14,
                   mfu: float = 0.4, speed_factors: Tuple[float, ...] = ()
                   ) -> "ComputeProfile":
        """The base compute time from a flop count and a device peak."""
        return cls(grad_s=flops_per_step / (device_flops * mfu),
                   speed_factors=speed_factors)

    def rank_seconds(self, num_devices: int) -> np.ndarray:
        if not self.speed_factors:
            return np.full((num_devices,), self.grad_s)
        if len(self.speed_factors) != num_devices:
            raise ValueError(f"need {num_devices} speed factors, got "
                             f"{len(self.speed_factors)}")
        return self.grad_s * np.asarray(self.speed_factors, np.float64)


DEFAULT_LINK = LinkProfile()
DEFAULT_COMPUTE = ComputeProfile()


@dataclasses.dataclass(frozen=True)
class StepTimer:
    """Simulated wall-clock and bytes ledger of one coded step.

    wire: the phase-1 wire (bytes via `rank_wire_bytes`).
    n: flat coordinates per rank on the wire.
    phase2_itemsize: bytes/coord of the broadcast (4 = f32, 2 = bf16).
    num_buckets: buckets of the flat vector (one exchange each; the serial
      schedule pays the per-message latency per bucket).
    overlap: price the pipelined bucket schedule: a 3-stage pipeline pack
      -> uplink -> downlink over the buckets, whose bottleneck stage is
      paid B-1 times after the fill (changes nothing when B = 1).
    pack_s: per-step local pack seconds, the pipeline's compute stage.
    """

    wire: Wire
    n: int
    link: LinkProfile = DEFAULT_LINK
    compute: ComputeProfile = DEFAULT_COMPUTE
    phase2_itemsize: int = 4
    num_buckets: int = 1
    overlap: bool = False
    pack_s: float = 0.0

    def __post_init__(self):
        if self.num_buckets < 1:
            raise ValueError("num_buckets must be >= 1")
        if self.pack_s < 0:
            raise ValueError("pack_s must be >= 0")

    def bytes_up(self) -> int:
        """Phase-1 payload bytes of one rank (the shipped shape)."""
        return int(self.wire.wire_bytes(self.n))

    def bytes_up_ranks(self, num_ranks: int) -> np.ndarray:
        """(num_ranks,) per-rank phase-1 bytes."""
        return self.wire.rank_wire_bytes(self.n, num_ranks)

    def bytes_down(self) -> int:
        """Phase-2 broadcast bytes received by one rank."""
        return self.n * self.phase2_itemsize

    def _waves(self, participants: np.ndarray) -> np.ndarray:
        f = self.link.server_fanin
        if f <= 0:
            return np.ones_like(participants, dtype=np.float64)
        return np.ceil(participants / f)

    def step_time(self, mask: Sequence[float]) -> float:
        """Seconds for one step under participation mask (N,)."""
        t, _, _ = self.steps(np.asarray(mask)[None, :])
        return float(t[0])

    def steps(self, trace: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Over a (T, N) mask trace: (step seconds (T,), uplink bytes (T,):
        participants x payload, downlink bytes (T,): every rank receives
        the broadcast).  An all-straggler step waits out the slowest
        compute, sends nothing up and still broadcasts the zero
        aggregate."""
        trace = np.asarray(trace, np.float64)
        T, N = trace.shape
        comp = self.compute.rank_seconds(N)                    # (N,)
        b_up_r = self.bytes_up_ranks(N).astype(np.float64)     # (N,)
        up_r = self.link.up_s_ranks(b_up_r)                    # (N,)
        participants = trace.sum(axis=1)                       # (T,)
        t_comp = np.where(participants > 0,
                          np.max(np.where(trace > 0, comp[None, :], 0.0),
                                 axis=1),
                          comp.max())
        lat = self.link.latency_s
        B = self.num_buckets
        xfer_r = up_r - lat                                    # (N,) s
        xfer_max = np.max(np.where(trace > 0, xfer_r[None, :], 0.0), axis=1)
        waves = self._waves(participants)
        has_up = (participants > 0).astype(np.float64)
        down_xfer = self.link.down_s(self.bytes_down()) - lat
        if self.overlap and B > 1:
            pack_b = self.pack_s / B
            up_b = has_up * waves * (lat + xfer_max / B)
            down_b = lat + down_xfer / B
            bottleneck = np.maximum(np.maximum(pack_b, up_b), down_b)
            t_agg = pack_b + up_b + down_b + (B - 1) * bottleneck
        else:
            t_up = has_up * waves * (B * lat + xfer_max)
            t_down = B * lat + down_xfer
            t_agg = self.pack_s + t_up + t_down
        times = t_comp + t_agg
        bytes_up = trace @ b_up_r
        bytes_down = np.full((T,), float(N * self.bytes_down()))
        return times, bytes_up, bytes_down


def solve_k_budgets(n: int, num_ranks: int, link: LinkProfile, *,
                    block_size: int = 512, value_dtype: str = "float32",
                    k_ref: int = 8, deadline_s: Optional[float] = None,
                    k_min: int = 1) -> Tuple[int, ...]:
    """Equal-time per-rank block top-K budgets for heterogeneous uplinks:
    k_i so that rank i's `SparseWire(k_i, block_size)` uplink fits one
    deadline (default: the uplink seconds of `SparseWire(k_ref)` on the
    nominal bandwidth),

        k_i = floor((deadline_bytes_i / nblocks - scale_bytes)
                    / (index_bytes + value_bytes)),

    clipped to [k_min, block_size].  Feed the result to
    `TrainRun(k_budgets=...)` or `PlanSpec(k_per_block=...)`."""
    if n % block_size:
        raise ValueError(f"n={n} must be a multiple of block_size="
                         f"{block_size} (pad upstream)")
    wire = SparseWire(k_per_block=k_ref, block_size=block_size,
                      value_dtype=value_dtype)
    if deadline_s is None:
        deadline_s = link.latency_s + \
            wire.wire_bytes(n) * 8.0 / (link.bandwidth_gbps * 1e9)
    if deadline_s <= link.latency_s:
        raise ValueError(f"deadline {deadline_s}s is not above the link "
                         f"latency {link.latency_s}s")
    bw = link.up_bandwidths(num_ranks)                         # Gbit/s
    budget_bytes = (deadline_s - link.latency_s) * bw * 1e9 / 8.0
    nb = n // block_size
    idx_b = 2 if block_size <= (1 << 16) else 4
    val_b = ref.wire_dtype(value_dtype).itemsize
    # epsilon before the floor: the deadline->bytes round trip loses an ulp,
    # which would otherwise knock an exactly-affordable k down by one
    k = np.floor((budget_bytes / nb - 4.0) / (idx_b + val_b) + 1e-9)
    k = np.clip(k, k_min, block_size).astype(np.int64)
    return tuple(int(v) for v in k)
