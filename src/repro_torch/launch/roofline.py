"""Roofline terms of a step on the card (the port's counterpart of
`repro.launch.hlo_analysis`): the time its operations, its memory traffic
and its collective traffic each need at the card's peak rates, and which
of the three bounds the step.

`WIRE_FACTOR` turns a collective's result bytes into one device's bytes
on the wire with the ring algorithms' factors (JAX's):

  all-gather       out * (g-1)/g          (receives everyone else's shard)
  all-reduce       out * 2(g-1)/g         (reduce-scatter + all-gather ring)
  reduce-scatter   out * (g-1)            (out is the scattered shard)
  all-to-all       out * (g-1)/g
  collective-permute  out                 (one hop)

The rates are arguments.  Their defaults are the figures of one NVIDIA
H100 80GB HBM3 (SXM) at its 700 W power limit (`CARD`, as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` names it):
  989 TFLOP/s  dense bf16 on the tensor cores (the data sheet);
  67 TFLOP/s   f32 on the CUDA cores (the data sheet; TF32 off, as the
               port runs);
  3.35 TB/s    HBM3;
  50 GB/s      a device's link on a mesh axis: one 400 Gb/s NDR
               InfiniBand port per GPU.  A 16-wide data axis spans two
               8-GPU NVLink nodes, so every ring of the coded collective
               crosses the inter-node network, and its slowest hop, not
               NVLink's 450 GB/s a direction, sets its rate.
A card set below 700 W runs slower under load: pass its own rates.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

__all__ = ["CARD", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "DTYPE_BYTES",
           "WIRE_FACTOR", "wire_bytes", "roofline_terms"]

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
LINK_BW = 50e9

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

WIRE_FACTOR = {
    "all-gather": lambda g: (g - 1) / g,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


def wire_bytes(op: str, result_bytes: float, group: int) -> float:
    """One device's wire bytes of a collective of `group` devices."""
    return result_bytes * WIRE_FACTOR[op](max(group, 1))


Flops = Union[float, Mapping[str, float]]


def _compute_s(flops: Flops, peak: Flops) -> float:
    if isinstance(flops, Mapping):
        return sum(f / peak[dt] for dt, f in flops.items())
    return flops / (peak if not isinstance(peak, Mapping)
                    else peak["bfloat16"])


def roofline_terms(flops_per_device: Flops, bytes_per_device: float,
                   wire_bytes_per_device: float,
                   peak_flops: Flops = PEAK_FLOPS["bfloat16"],
                   hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Dict[str, float]:
    """compute, memory and collective seconds, the dominant term, the
    bound and compute's share of it.  flops_per_device is a number, or
    {dtype: flops} with peak_flops {dtype: rate} (each dtype at its own
    peak, e.g. `PEAK_FLOPS`)."""
    compute_s = _compute_s(flops_per_device, peak_flops)
    memory_s = bytes_per_device / hbm_bw
    collective_s = wire_bytes_per_device / link_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "bound_s": total,
        "roofline_fraction": (compute_s / total) if total > 0 else 0.0,
    }
