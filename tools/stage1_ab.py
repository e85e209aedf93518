#!/usr/bin/env python3
"""Stage 1 (the N coding ranks' loss and backward into the flat gradient,
as `train_step` runs it) of zamba2-2.7b and xlstm-1.3b on one NVIDIA GPU,
timed for two or more source trees of the port in one call, so that a
change to their recurrent layers (`nn/ssm.py`, `nn/xlstm.py`) can be held
against its parent on the same card.

    PYTHONPATH=src python tools/stage1_ab.py --trees A,B,B,A [--reps 5]
        [--cells ARCH:SEQ,...]

Each entry of --trees is a checkout's root (its `src/` is imported); each
runs in a process of its own, in the order given (parent, change, change,
parent). The cells (--cells, default all four): chip_smoke.py's phase-10
cell (full width, depth ZAMBA2_LAYERS / XLSTM_LAYERS, seq 512, global
batch 4, N = 4 ranks) and the same at seq 4096. Prints one JSON line per
tree and cell: the median and every one of --reps timed stage 1s (host
seconds from a CUDA synchronise to one, after one untimed), the card's
name and power limit.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELLS = "zamba2-2.7b:512,xlstm-1.3b:512,zamba2-2.7b:4096,xlstm-1.3b:4096"


def stage1(torch, setup, batch) -> float:
    """Host seconds of one stage 1, synchronise to synchronise."""
    m = setup.model
    inputs, weights = batch[:setup.n_inputs], setup.batch_weights(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(setup.n_code):
        m.grad.zero_()
        xs = [x[i] for x in inputs]
        loss, _ = m.loss(xs[0], weights[i], *xs[1:])
        loss.backward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def one_tree(tree: str, reps: int, cells: str) -> None:
    import torch
    import chip_smoke as cs
    sys.path.insert(0, str(Path(tree) / "src"))
    import repro_torch
    from repro_torch.configs import REGISTRY, ShapeCfg
    from repro_torch.launch.train import TrainRun, build_train_setup
    layers = {"zamba2-2.7b": cs.ZAMBA2_LAYERS, "xlstm-1.3b": cs.XLSTM_LAYERS}
    for cell in cells.split(","):
        arch, seq = cell.split(":")
        seq = int(seq)
        spec = REGISTRY[arch]
        spec = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, num_layers=layers[arch]))
        setup = build_train_setup(
            spec, ShapeCfg("train", seq, cs.GLOBAL_BATCH),
            TrainRun(base_lr=5e-3, compressor="sign"), smoke=False,
            n_code=cs.N_CODE, device="cuda")
        batch = setup.batch_to_device(setup.host_batch(0))
        stage1(torch, setup, batch)
        times = [stage1(torch, setup, batch) for _ in range(reps)]
        print(json.dumps({"tree": tree, "src": repro_torch.__file__,
                          "arch": arch,
                          "layers": layers[arch], "seq": seq,
                          "global_batch": cs.GLOBAL_BATCH,
                          "n_code": cs.N_CODE,
                          "median_s": statistics.median(times),
                          "times_s": times}), flush=True)
        del setup, batch
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cells", default=CELLS)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        one_tree(a.one, a.reps, a.cells)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for tree in a.trees.split(","):
        r = subprocess.run([sys.executable, __file__, "--trees", a.trees,
                            "--reps", str(a.reps), "--cells", a.cells,
                            "--one",
                            str(Path(tree).resolve())])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
