"""The reference-versus-step parity gate of Algorithm 1 (port of
`repro.launch.parity`).

The port has two implementations of Algorithm 1: the (N, D) reference
loop (`core.error_feedback.cocoef_step`, the paper's figures) and the
coded step (`core.cocoef`: `cocoef_update` with every coding rank on one
device, or `group_cocoef_update` with one process per coding rank).
`run_parity` trains both on the same linear regression (`data.tasks`),
allocation, encode weights, straggler masks and wire: the loop's
compressor is `WireCompressor(wire)`, the reconstruction the collective's
receivers decode.  theta and the error vectors must stay bit-identical
at every step of the trained run.

Both sides take their coded gradients from the same function
(`error_feedback._coded_gradients`), and the step runs on `shards`
contiguous slices of the vector, as JAX's step runs on the model axis of
its (N, shards) mesh.  With a coding grid (`group`, 1-D: on a grid with
an outer axis the sums associate otherwise, see `core.collectives`) this
process is one coding rank: it compares theta and its own error row.
The two sides run in lockstep, so nothing is stored per step.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import coding, error_feedback as EF, prng
from repro_torch.core.coding_state import CodingPlan, maybe_replan
from repro_torch.core.cocoef import (CocoEFConfig, cocoef_update,
                                     group_buffers, group_cocoef_update)
from repro_torch.core.compression import WireCompressor
from repro_torch.data import tasks
from repro_torch.launch.train import _payload_buffers

__all__ = ["PARITY_COMPRESSORS", "run_parity", "assert_parity",
           "reference_loop"]

# sign, block top-K and the dense wire; global top-K is left out by
# design: its block is the all_to_all chunk, so the whole-vector reference
# and the per-shard step compress over other blocks
PARITY_COMPRESSORS = ("sign", "block_topk", "identity")

_GROUP, _BLOCK, _K = 32, 64, 4


def _setup(compressor, N, dim, shards, p, d, seed, device, ccfg):
    if compressor not in PARITY_COMPRESSORS:
        raise ValueError(f"parity covers {PARITY_COMPRESSORS}, got "
                         f"{compressor!r}")
    n_loc = dim // shards
    wire = ccfg.wire_format(n_loc, N)
    # dim must need no padding: the reference compresses the raw (dim,)
    # vector, so a pad would move the groups and blocks of one side
    wire.check(n_loc, N)
    grad_fn, loss_fn, theta0, _ = tasks.linreg_task(seed, N, dim, device)
    W = coding.encode_weights(coding.cyclic_allocation(N, N, d), p)
    mask_key = prng.PRNGKey(1000 + seed)
    return (WireCompressor(wire=wire), grad_fn, loss_fn, theta0, W,
            lambda t: coding.straggler_mask(mask_key, t, N, p).to(device))


def _config(compressor, group_size, block_size, k_per_block, num_buckets,
            bucket_schedule) -> CocoEFConfig:
    return CocoEFConfig(group_size=group_size, compressor=compressor,
                        block_size=block_size, k_per_block=k_per_block,
                        num_buckets=num_buckets,
                        bucket_schedule=bucket_schedule)


def reference_loop(compressor: str = "sign", T: int = 20, N: int = 4,
                   shards: int = 2, dim: int = 1024, gamma: float = 2e-6,
                   p: float = 0.25, d: int = 2, seed: int = 0,
                   device="cuda", group_size: int = _GROUP,
                   block_size: int = _BLOCK, k_per_block: int = _K
                   ) -> EF.EFState:
    """`run_parity`'s reference side alone: the final state of T steps of
    the (N, D) loop on `device`."""
    ccfg = _config(compressor, group_size, block_size, k_per_block, 1,
                   "serial")
    comp, grad_fn, _, theta0, W, mask = _setup(compressor, N, dim, shards,
                                               p, d, seed, device, ccfg)
    st = EF.EFState.init(theta0, N)
    for t in range(T):
        st = EF.cocoef_step(st, grad_fn, W, mask(t), gamma, comp, step=t)
    return st


def run_parity(compressor: str = "sign", T: int = 20, N: int = 4,
               shards: int = 2, dim: int = 1024, gamma: float = 2e-6,
               p: float = 0.25, d: int = 2, seed: int = 0,
               num_buckets: int = 1, bucket_schedule: str = "pipelined",
               dynamic_state: bool = False, device="cuda", group=None,
               group_size: int = _GROUP, block_size: int = _BLOCK,
               k_per_block: int = _K) -> Dict:
    """Train the reference loop and the coded step for T steps on the same
    task, masks and wire (JAX's parity sizes by default: group 32, block
    64, k 4) and compare them.  group: a 1-D `launch.mesh.CodingGrid` of
    N processes (None: every rank on this device).  Returns a report;
    `bitexact` is True iff theta and the error vectors (this rank's row
    with a grid) are bit-equal at every step.

    dynamic_state=True adds JAX's third trajectory: the same step with the
    encode weights of a live `core.coding_state.CodingPlan` pinned to the
    oracle rates, recomputed by `maybe_replan` every step; it must equal
    the reference too (the elastic plane's acceptance criterion)."""
    if group is not None and (group.size != N or group.n_outer != 1):
        raise ValueError(f"parity holds on a 1-D grid of N={N} ranks, got "
                         f"{group.shape}")
    ccfg = _config(compressor, group_size, block_size, k_per_block,
                   num_buckets, bucket_schedule)
    comp, grad_fn, loss_fn, theta0, W, mask = _setup(
        compressor, N, dim, shards, p, d, seed, device, ccfg)
    n_loc = dim // shards
    parts = [slice(s * n_loc, (s + 1) * n_loc) for s in range(shards)]
    rows = list(range(N)) if group is None else [group.rank]

    st = EF.EFState.init(theta0, N)
    if group is None:
        bufs = [_payload_buffers(ccfg, N, n_loc, device) for _ in parts]
    else:
        bufs = [group_buffers(ccfg, group.nd, n_loc, device) for _ in parts]

    def coded_step(theta, e, Wt, m):
        """theta - ghat of one step, e updated in place."""
        g = EF._coded_gradients(grad_fn, theta, Wt)
        ghat = torch.empty_like(theta)
        for sl, buf in zip(parts, bufs):
            if group is None:
                ghat[sl] = cocoef_update(lambda i, sl=sl: g[i, sl], e[:, sl],
                                         m, gamma, ccfg, buf)
            else:
                group_cocoef_update(g[group.rank, sl], e[0, sl], m, gamma,
                                    ccfg, group, buf, out=ghat[sl])
        return theta - ghat

    # side -> [theta, this setup's error rows]; "dynamic" takes its W from
    # the live plane (the iid oracle rates are uniform, so maybe_replan's
    # W is encode_weights(alloc, p) bit for bit)
    sides = {"step": [theta0.clone(), None]}
    if dynamic_state:
        oracle = np.full((N,), 1.0 - p)
        plan = CodingPlan.create(oracle, N, d,
                                 allocation=coding.cyclic_allocation(N, N, d))
        sides["dynamic"] = [theta0.clone(), None]
    for side in sides.values():
        side[1] = torch.zeros((len(rows), dim), dtype=torch.float32,
                              device=device)
    first_div: Optional[Dict] = None
    max_dtheta = max_de = 0.0
    for t in range(T):
        m = mask(t)
        st = EF.cocoef_step(st, grad_fn, W, m, gamma, comp, step=t)
        for name, side in sides.items():
            Wt = W
            if name == "dynamic":
                cs, info = maybe_replan(plan, oracle)
                if info["reallocated"]:
                    raise AssertionError("pinned rates must never drift")
                Wt = cs.W
            side[0] = coded_step(side[0], side[1], Wt, m)
            for field, a, b in (("theta", st.theta, side[0]),
                                ("e", st.e[rows], side[1])):
                if torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    continue
                diff = (a - b).abs().max().item()
                if field == "theta":
                    max_dtheta = max(max_dtheta, diff)
                else:
                    max_de = max(max_de, diff)
                if first_div is None:
                    first_div = {"step": t, "field": field, "side": name,
                                 "max_abs_diff": diff}
    theta = sides["step"][0]
    return {
        "compressor": compressor, "wire": type(comp.wire).__name__,
        "T": T, "N": N, "shards": shards, "dim": dim, "gamma": gamma,
        "p": p, "d": d, "num_buckets": num_buckets,
        "bucket_schedule": bucket_schedule, "device": str(device),
        "dynamic_state": dynamic_state,
        "grid": None if group is None else list(group.shape),
        "bitexact": first_div is None, "first_divergence": first_div,
        "max_abs_diff_theta": max_dtheta, "max_abs_diff_e": max_de,
        "loss_start": loss_fn(theta0), "loss_ref": loss_fn(st.theta),
        "loss_step": loss_fn(theta),
    }


def assert_parity(report: Dict) -> None:
    if not report["bitexact"]:
        div = report["first_divergence"]
        raise AssertionError(
            f"reference loop and coded step diverged on "
            f"{report['compressor']} ({report['wire']}, buckets "
            f"{report['num_buckets']} {report['bucket_schedule']}): first "
            f"at step {div['step']} in {div['field']} (|diff| up to "
            f"theta={report['max_abs_diff_theta']:.3e}, "
            f"e={report['max_abs_diff_e']:.3e})")
