"""The train step on one device against the same step on the CPU.

`step_parity(device, compressor, k_budgets, mode)` builds the f32
smoke-size gemma2-2b slice (g = 32, N = 4; sign wire, or block top-K with
k = 8, B = 256, f32 values, uniform or with one k budget per rank; cocoef
or coco mode) on the CPU and on `device`, from the same parameters, and
checks two things:

  full step   one `train_step` from the same batch and mask (rank 1 a
              straggler).  Stage 1 sums in another order on each device, so
              acc differs in its last bits.  The loss must agree within 1e-4
              relative, and fewer than 1% of the coordinates of theta may be
              more than 1e-6 apart.  theta must agree within TOL * N *
              (max scale) + 1e-6, the most that flipped decisions near a
              tie can move a coordinate: a sign bit flipped by a near-zero
              accumulator moves c by 2 * (group scale), so TOL = 2 on the
              sign wire; a top-K selection flipped at a near-tie swaps one
              kept coordinate for another, each |c| <= |acc| <= the block
              scale, so TOL = 1 on the block top-K wire (summed over the N
              ranks, whose payloads add into ghat).
  stage 2     `coded_update` fed the same injected gradients and error
              vectors on both devices.  The kernels equal their plain
              versions bit for bit, so the payload rows, the error vectors
              (updated in place), ghat (written into the gradient buffer)
              and theta must all be bit-equal: a mix-up of rank rows,
              payload rows or buffers cannot hide in a tolerance.  The
              injected blocks include a zero block, a -0.0 block and, on
              the block top-K wire, k + 1 equal maxima of mixed sign and a
              block of exactly k nonzeros.  In coco mode every error
              vector must keep the bits it had before the step.

It raises AssertionError on a miss.  `chip_smoke.py` and the `gpu` tests
run it with device="cuda"; on the CPU it also runs against itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.launch.train import TrainRun, TrainSetup, build_train_setup

__all__ = ["step_parity"]

MASK = (1.0, 0.0, 1.0, 1.0)


FLIP = {"sign": 2.0, "block_topk": 1.0}     # TOL of the docstring
PAYLOAD = {"sign": ("words", "scales"),
           "block_topk": ("idx", "values", "scales")}


def _setups(device, compressor: str, k_budgets: Optional[Tuple[int, ...]],
            mode: str) -> List[TrainSetup]:
    """Two separate setups, one on the CPU and one on `device`."""
    spec = REGISTRY["gemma2-2b"]
    spec = dataclasses.replace(
        spec, smoke=dataclasses.replace(spec.smoke, dtype="float32"),
        coding=dataclasses.replace(spec.coding, group_size=32))
    run = TrainRun(base_lr=5e-3, compressor=compressor, k_budgets=k_budgets,
                   mode=mode)
    return [build_train_setup(spec, ShapeCfg("train", 32, 8), run,
                              smoke=True, device=d)
            for d in ("cpu", device)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu()
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _adversarial_(grads: torch.Tensor, e0: torch.Tensor, L: int,
                  k: Optional[int]) -> None:
    """Blocks of length L at the start of every rank's row: zeros, -0.0,
    and with k (block top-K): k + 1 equal maxima of mixed sign, then a
    block of exactly k nonzeros."""
    grads[:, :L] = 0.0
    e0[:, :L] = 0.0
    grads[:, L:2 * L] = -0.0
    e0[:, L:2 * L] = -0.0
    if k is None:
        return
    tie = grads[:, 2 * L:3 * L]
    tie.mul_(1e-3)
    tie[:, 5:5 + 3 * (k + 1):3] = 2.0
    tie[:, 8:8 + 6 * ((k + 1) // 2):6] = -2.0
    e0[:, 2 * L:3 * L] = 0.0
    grads[:, 3 * L:4 * L] = 0.0
    grads[:, 3 * L + 7:3 * L + 7 + 5 * k:5] = 1.5
    e0[:, 3 * L:4 * L] = 0.0


def step_parity(device="cuda", seed: int = 0, compressor: str = "sign",
                k_budgets: Optional[Tuple[int, ...]] = None,
                mode: str = "cocoef") -> Dict[str, float]:
    """Run both checks (see the module docstring); returns the measured
    gaps of the full step."""
    cpu, dev = _setups(device, compressor, k_budgets, mode)
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
                    s.payload[-1].max().item()))
    (l0, t0, s0), (l1, t1, s1) = res
    d = (t0 - t1).abs()
    out = {"loss_cpu": l0, "loss_device": l1,
           "max_abs_dtheta": d.max().item(),
           "frac_dtheta_over_1e-6": (d > 1e-6).float().mean().item()}
    assert np.isfinite(l1) and abs(l0 - l1) <= 1e-4 * abs(l0), out
    assert out["max_abs_dtheta"] <= \
        FLIP[compressor] * n_code * max(s0, s1) + 1e-6, out
    assert out["frac_dtheta_over_1e-6"] < 0.01, out

    rng = np.random.default_rng(seed)
    ccfg = cpu.cocoef_cfg
    L = ccfg.pad_multiple
    mag = np.repeat(np.exp(rng.uniform(-12, 2, (n_code, n // L))), L, 1)
    grads = torch.from_numpy((rng.standard_normal((n_code, n)) * mag)
                             .astype(np.float32))
    e0 = torch.from_numpy((rng.standard_normal((n_code, n)) * mag * 1e-2)
                          .astype(np.float32))
    _adversarial_(grads, e0, L, ccfg.wire.k_max
                  if compressor == "block_topk" else None)
    got = []
    for s in (cpu, dev):
        s.model.theta.copy_(theta0)
        g = grads.to(s.device, copy=True)
        e = e0.to(s.device, copy=True)        # updated in place below

        def grad_of(i, s=s, g=g):
            s.model.grad.copy_(g[i])
            return s.model.grad
        s.coded_update(s.model, grad_of, e, mask.to(s.device), 1)
        got.append({**dict(zip(PAYLOAD[compressor], s.payload)), "e": e,
                    "ghat": s.model.grad, "theta": s.model.theta})
    for k in got[0]:
        a, b = _bits(got[0][k]), _bits(got[1][k])
        assert torch.equal(a, b), (
            f"stage 2 on {device} ({mode}, {compressor}, budgets "
            f"{k_budgets}): {k} differs from the CPU in "
            f"{int((a != b).sum())} of {a.numel()} entries")
    # cocoef leaves the straggler's error alone, coco every rank's
    for i in (range(n_code) if mode == "coco" else [1]):
        assert torch.equal(_bits(got[0]["e"][i]), _bits(e0[i])), \
            f"{mode}: rank {i}'s error vector changed"
    return out
