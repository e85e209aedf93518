"""Quickstart: COCO-EF on the paper's linear-regression task (Sec. V.A),
the port of `examples/quickstart.py`.

Runs the proposed method next to the 1-bit unbiased baseline [32] at equal
communication overhead (N = M = 100 ranks and subsets, d = 5, 20%
stragglers) through the reference loop and prints F(theta) every 60
steps, in JAX's lines.  linreg's dot products and F are summed in fixed
trees (`data.tasks`), so the card's trajectory equals the CPU's bit for
bit.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import coding, compression as C, error_feedback as EF
from repro_torch.core import prng
from repro_torch.data.tasks import linreg_task

N = M = 100
# name: (step, compressor, learning rate, takes a key)
RUNS = {
    "COCO-EF (Sign)  [proposed]": (EF.cocoef_step, C.GroupedSign(), 1e-5,
                                   False),
    "Unbiased (Sign) [baseline]": (EF.unbiased_step, C.StochasticSign(),
                                   2e-6, True),
}
PRINT_EVERY = 60


def main(device="cuda", steps: int = 301, every: int = PRINT_EVERY
         ) -> Dict[str, List[Tuple[int, float]]]:
    """Both runs for `steps` steps on `device`, F(theta) printed every
    `every` steps (JAX's 60); returns each run's printed (step, F(theta))
    pairs."""
    dev = resolve_device(device)
    grad_fn, loss_fn, theta0, _ = linreg_task(seed=0, device=dev)
    alloc = coding.random_allocation(seed=0, num_devices=N, num_subsets=M,
                                     d=5)
    W = coding.encode_weights(alloc, p=0.2)
    key = prng.PRNGKey(42)
    out = {}
    for name, (step_fn, comp, lr, needs_key) in RUNS.items():
        st = EF.EFState.init(theta0, N)
        print(f"\n{name}  (1 bit/coordinate on the wire)")
        out[name] = []
        for t in range(steps):
            mask = coding.straggler_mask(key, t, N, p=0.2)  # 20% stragglers
            kk = prng.fold_in(prng.PRNGKey(7), t) if needs_key else None
            st = step_fn(st, grad_fn, W, mask, lr, comp, step=t, key=kk)
            if t % every == 0:
                f = loss_fn(st.theta)
                out[name].append((t, f))
                print(f"  step {t:4d}  F(theta) = {f:12.1f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.quickstart",
        description="COCO-EF against the unbiased 1-bit baseline on the "
                    "linear regression (the port of examples/quickstart.py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=301)
    a = ap.parse_args()
    with torch.inference_mode():
        main(a.device, a.steps)
