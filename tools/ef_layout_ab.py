#!/usr/bin/env python3
"""Time `ef_sign_fused` at gemma2-2b's flat size on one CUDA card in two
layouts of the error vector, alternated A B B A over several rounds:

  A  standalone: g and e are separate (n,) tensors, the payload fresh
     (n/32,) and (n/g,) tensors;
  B  train step: e is row 1 of a (2, n) buffer and the payload goes into
     row 1 of (4, n/32) and (4, n/g) buffers, as `cocoef_update` runs it.

Both launch the same kernel on the same values, updating e in place with
mask 1, so a gap between them is the layout's.

    python3 tools/ef_layout_ab.py [--rounds 4] [--reps 10]

Prints the card's name and power limit, then one JSON line per round and
a summary line with the mean ms of each layout.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROUP, N_CODE = 512, 4


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import REGISTRY
    from repro_torch.core.cocoef import padded_size
    from repro_torch.kernels import sign_pack as sp
    from repro_torch.nn.transformer import num_params
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda", 0)
    n = padded_size(num_params(REGISTRY["gemma2-2b"].config), N_CODE, GROUP)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn(n, device=dev, generator=gen)
    e_a = torch.randn(n, device=dev, generator=gen) * 0.01
    e_b = torch.empty((2, n), device=dev)
    e_b[1].copy_(e_a)
    out_a = (torch.empty(n // 32, dtype=torch.uint32, device=dev),
             torch.empty(n // GROUP, device=dev), e_a)
    words = torch.empty((N_CODE, n // 32), dtype=torch.uint32, device=dev)
    scales = torch.empty((N_CODE, n // GROUP), device=dev)
    out_b = (words[1], scales[1], e_b[1])
    gamma, mask = torch.tensor(5e-3, device=dev), torch.ones((), device=dev)
    runs = {"A": lambda: sp.ef_sign_fused(g, e_a, gamma, mask, GROUP,
                                          out=out_a),
            "B": lambda: sp.ef_sign_fused(g, e_b[1], gamma, mask, GROUP,
                                          out=out_b)}

    def ms(fn) -> float:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    got = {"A": [], "B": []}
    for r in range(args.rounds):
        row = {}
        for k in ("AB" if r % 2 == 0 else "BA"):
            row[k] = ms(runs[k])
            got[k].append(row[k])
        print(json.dumps({"round": r, **row}), flush=True)
    mean = {k: sum(v) / len(v) for k, v in got.items()}
    print(json.dumps({"n": n, "reps": args.reps, "mean_ms": mean}))


if __name__ == "__main__":
    main()
