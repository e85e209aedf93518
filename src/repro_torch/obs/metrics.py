"""The train step's telemetry frame (port of `repro.obs.metrics`).

`MetricsFrame` has JAX's twelve fields.  JAX fills them per device inside
the jitted step and reduces the device grid afterwards
(`reduce_frame_grid`); the port runs the coding ranks of one device (or,
with a coding grid, its own rank) one after another, so the per-rank
fields are filled row by row, one row per rank the process runs (R):

  participation     (N,)   the straggler mask I^t
  wire_bytes_rank   (N,)   phase-1 bytes sent per coding rank this step:
                           mask_i * wire.rank_wire_bytes(n_b)[i] summed
                           over buckets (`sim.StepTimer.bytes_up_ranks`)
  bucket_wire_bytes (R, B) each rank's shipped bytes per bucket (x mask)
  bytes_down        ()     phase-2 bytes received per rank
  grad_norm_sq      (R,)   |g_i|^2 of the coded gradient
  ef_norm_sq        (R,)   |e_i|^2 after the update (0 where e is None:
                           the coco and dense modes never hold it)
  acc_norm_sq       (R,)   |gamma*g_i + e_i|^2 (the compressor input)
  c_norm_sq         (R,)   |C(acc_i)|^2
  acc_dot_c         (R,)   <acc_i, C(acc_i)>
  ghat_norm_sq      ()     |ghat|^2
  update_norm_sq    ()     |theta_new - theta|^2 (`optim.apply_update`)
  param_norm_sq     ()     |theta_new|^2

The sums are float64 on the step's device, each a sum of f32 chunk dot
products (`norm_sq`); XLA's reduction order cannot be followed (ROADMAP C3), so
they agree with JAX's f32 sums within a tolerance, while the integer-
valued fields (participation, bytes) are exact.  `reduce_frame` gives
the dict JAX's `reduce_frame_grid` gives (per-rank norms, the compressed-
vs-raw cosine and the contraction |acc - c|^2 / |acc|^2), which the
driver hands to `frame_to_host` and `MetricsLogger.log_step`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["MetricsFrame", "norm_sq", "reduce_frame", "frame_to_host",
           "CHUNK"]

CHUNK = 1 << 24     # elements per pass of the frame's sums (64 MiB of f32)


def norm_sq(x: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Sum of squares of a flat f32 (or bf16, widened a chunk at a time)
    tensor as float64: the f32 dot product of each `chunk` with itself
    (one read, no temporary in f32), summed in float64."""
    x = x.reshape(-1)
    out = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.numel(), chunk):
        xc = x[i:i + chunk].to(torch.float32)
        out += torch.dot(xc, xc).to(torch.float64)
    return out


@dataclasses.dataclass
class MetricsFrame:
    """One step's telemetry (module docstring for the fields)."""

    participation: torch.Tensor
    wire_bytes_rank: torch.Tensor
    bucket_wire_bytes: torch.Tensor
    bytes_down: torch.Tensor
    grad_norm_sq: torch.Tensor
    ef_norm_sq: torch.Tensor
    acc_norm_sq: torch.Tensor
    c_norm_sq: torch.Tensor
    acc_dot_c: torch.Tensor
    ghat_norm_sq: torch.Tensor
    update_norm_sq: torch.Tensor
    param_norm_sq: torch.Tensor

    def replace(self, **kw) -> "MetricsFrame":
        return dataclasses.replace(self, **kw)

    @classmethod
    def zeros(cls, n_ranks: int, rows: int, num_buckets: int,
              device) -> "MetricsFrame":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float64, device=device)
        return cls(participation=z(n_ranks), wire_bytes_rank=z(n_ranks),
                   bucket_wire_bytes=z(rows, num_buckets), bytes_down=z(),
                   grad_norm_sq=z(rows), ef_norm_sq=z(rows),
                   acc_norm_sq=z(rows), c_norm_sq=z(rows),
                   acc_dot_c=z(rows), ghat_norm_sq=z(), update_norm_sq=z(),
                   param_norm_sq=z())


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a / torch.where(b == 0, torch.ones_like(b), b)


def reduce_frame(frame: MetricsFrame) -> Dict[str, torch.Tensor]:
    """The frame -> the step metrics of JAX's `reduce_frame_grid` (same
    keys; per-rank entries in rank order)."""
    f = frame
    acc, c, dot = f.acc_norm_sq, f.c_norm_sq, f.acc_dot_c
    return {
        "participation": f.participation,
        "participants": f.participation.sum(),
        "wire_bytes_rank": f.wire_bytes_rank,
        "bytes_up_total": f.wire_bytes_rank.sum(),
        "bucket_wire_bytes_rank": f.bucket_wire_bytes,
        "bytes_down": f.bytes_down,
        "grad_norm_rank": torch.sqrt(f.grad_norm_sq),
        "ef_norm_rank": torch.sqrt(f.ef_norm_sq),
        "compress_cosine_rank": _safe_div(dot, torch.sqrt(acc)
                                          * torch.sqrt(c)),
        "compress_contraction_rank": _safe_div(acc + c - 2.0 * dot, acc),
        "ghat_norm": torch.sqrt(f.ghat_norm_sq),
        "update_norm": torch.sqrt(f.update_norm_sq),
        "param_norm": torch.sqrt(f.param_norm_sq),
    }


def frame_to_host(reduced: Dict[str, object]) -> Dict[str, object]:
    """Tensors -> plain python (lists/floats) for JSONL logging."""
    out = {}
    for k, v in reduced.items():
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        out[k] = a.tolist() if a.ndim else float(a)
    return out
