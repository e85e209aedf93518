"""The train step on one device against the same step on the CPU.

`step_parity(device)` builds the f32 smoke-size gemma2-2b slice (sign wire,
g = 32, N = 4) on the CPU and on `device`, from the same parameters, and
checks two things:

  full step   one `train_step` from the same batch and mask (rank 1 a
              straggler).  Stage 1 sums in another order on each device, so
              the loss must agree within 1e-4 relative and theta within
              2*N*(max group scale) + 1e-6 — the most that sign bits flipped
              by near-zero accumulators can move a coordinate — with fewer
              than 1% of the coordinates more than 1e-6 apart.
  stage 2     `coded_update` fed the same injected gradients and error
              vectors on both devices.  The kernels equal their plain
              versions bit for bit, so the payload rows, the error vectors
              (updated in place), ghat (written into the gradient buffer)
              and theta must all be bit-equal: a mix-up of rank rows,
              payload rows or buffers cannot hide in a tolerance.

It raises AssertionError on a miss.  `chip_smoke.py` and the `gpu` tests
run it with device="cuda"; on the CPU it also runs against itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.launch.train import TrainRun, TrainSetup, build_train_setup

__all__ = ["step_parity"]

MASK = (1.0, 0.0, 1.0, 1.0)


def _setups(device) -> List[TrainSetup]:
    """Two separate setups, one on the CPU and one on `device`."""
    spec = REGISTRY["gemma2-2b"]
    spec = dataclasses.replace(
        spec, smoke=dataclasses.replace(spec.smoke, dtype="float32"),
        coding=dataclasses.replace(spec.coding, group_size=32))
    return [build_train_setup(spec, ShapeCfg("train", 32, 8),
                              TrainRun(base_lr=5e-3), smoke=True, device=d)
            for d in ("cpu", device)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def step_parity(device="cuda", seed: int = 0) -> Dict[str, float]:
    """Run both checks (see the module docstring); returns the measured
    gaps of the full step."""
    cpu, dev = _setups(device)
    n_code, n = cpu.n_code, cpu.flat_pad
    cpu.init_state()
    theta0 = cpu.model.theta.clone()
    mask = torch.tensor(MASK)

    res = []
    for s in (cpu, dev):
        s.model.theta.copy_(theta0)
        e = torch.zeros((n_code, n), device=s.device)
        m = s.train_step(s.model, e, s.make_batch(0), 0, masks=mask)
        res.append((m["loss"].item(), s.model.theta.cpu(),
                    s.payload[1].max().item()))
    (l0, t0, s0), (l1, t1, s1) = res
    d = (t0 - t1).abs()
    out = {"loss_cpu": l0, "loss_device": l1,
           "max_abs_dtheta": d.max().item(),
           "frac_dtheta_over_1e-6": (d > 1e-6).float().mean().item()}
    assert np.isfinite(l1) and abs(l0 - l1) <= 1e-4 * abs(l0), out
    assert out["max_abs_dtheta"] <= 2 * n_code * max(s0, s1) + 1e-6, out
    assert out["frac_dtheta_over_1e-6"] < 0.01, out

    rng = np.random.default_rng(seed)
    G = cpu.cocoef_cfg.group_size
    mag = np.repeat(np.exp(rng.uniform(-12, 2, (n_code, n // G))), G, 1)
    grads = torch.from_numpy((rng.standard_normal((n_code, n)) * mag)
                             .astype(np.float32))
    e0 = torch.from_numpy((rng.standard_normal((n_code, n)) * mag * 1e-2)
                          .astype(np.float32))
    grads[:, :G] = 0.0              # a zero group and a -0.0 group
    e0[:, :G] = 0.0
    grads[:, G:2 * G] = -0.0
    e0[:, G:2 * G] = -0.0
    got = []
    for s in (cpu, dev):
        s.model.theta.copy_(theta0)
        g = grads.to(s.device, copy=True)
        e = e0.to(s.device, copy=True)        # updated in place below

        def grad_of(i, s=s, g=g):
            s.model.grad.copy_(g[i])
            return s.model.grad
        s.coded_update(s.model, grad_of, e, mask.to(s.device), 1)
        got.append({"words": s.payload[0], "scales": s.payload[1], "e": e,
                    "ghat": s.model.grad, "theta": s.model.theta})
    for k in got[0]:
        a, b = _bits(got[0][k]), _bits(got[1][k])
        assert torch.equal(a, b), (
            f"stage 2 on {device}: {k} differs from the CPU in "
            f"{int((a != b).sum())} of {a.numel()} entries")
    assert torch.equal(_bits(got[0]["e"][1]), _bits(e0[1])), \
        "the straggler's error vector changed"
    return out
