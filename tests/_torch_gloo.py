"""The port's process-group runs for the CPU tests: 4 processes on gloo,
each one coding rank, started once per test module (`run_gloo`) and
writing what it computed to `rank<r>.pt` for the tests to compare.

  parity   on a 1-D grid (4,): `run_parity` for every wire x buckets
           {1, 2} x schedule, an all-straggler step; on the 1-D grid and
           on a 2 x 2 grid: `group_cocoef_update` on every case of
           `_torch_cases.MESH_CASES`.
  train    the smoke gemma2 slice (2 layers, sign wire, g = 32), 3 steps
           of `build_train_setup(..., group=grid)`.
  dtypes   `group_cocoef_update` on every case of
           `_torch_cases.dtype_case_names()` (g and e stored in bf16), and
           3 steps of the train job with TrainRun(param_dtype="bfloat16",
           ef_dtype="bfloat16") on the sign and block top-K wires.
  serve    the sharded serve on the process mesh (`launch.mesh.
           process_mesh`, one device a process) of every (arch, mesh) of
           `_torch_cases.SHARD_CASES`: `_torch_cases.run_sharded`'s
           prefill and decode steps, each device's logits and cache
           blocks.

Every process runs on one thread (stage 1 on the CPU depends on the
thread count; the one-device runs the tests compare with do the same).
No JAX here.  Run as `python tests/_torch_gloo.py JOB OUTDIR`."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
WORLD = 4
PARITY_CASES = [(c, b, s) for c in ("sign", "block_topk", "identity")
                for b in (1, 2) for s in ("serial", "pipelined")]
TRAIN_STEPS = 3


def train_spec():
    """The smoke gemma2 config of the train job, in f32, 2 layers, g 32."""
    from repro_torch.configs import REGISTRY
    spec = REGISTRY["gemma2-2b"]
    return dataclasses.replace(
        spec, smoke=dataclasses.replace(spec.smoke, dtype="float32",
                                        num_layers=2),
        coding=dataclasses.replace(spec.coding, group_size=32))


def _parity(rank, out):
    from _torch_cases import (MESH_CASES, MESH_GAMMA, MESH_MASK,
                              mesh_inputs)
    from repro_torch.core.cocoef import (CocoEFConfig, group_buffers,
                                         group_cocoef_update)
    from repro_torch.launch.mesh import coding_grid
    from repro_torch.launch.parity import run_parity
    grids = {1: coding_grid((WORLD,)), 2: coding_grid((2, 2))}
    for c, b, s in PARITY_CASES:
        r = run_parity(c, num_buckets=b, bucket_schedule=s, device="cpu",
                       group=grids[1])
        out[f"parity/{c}/{b}/{s}"] = (r["bitexact"], r["first_divergence"])
    for name, (axes, kw, kind) in MESH_CASES.items():
        g, e = (torch.from_numpy(x[rank].copy()) for x in mesh_inputs(kind))
        cfg = CocoEFConfig(group_size=32, **kw)
        grid = grids[len(axes)]
        bufs = group_buffers(cfg, grid.nd, g.numel(), "cpu")
        ghat = group_cocoef_update(g, e if cfg.mode == "cocoef" else None,
                                   torch.tensor(MESH_MASK), MESH_GAMMA, cfg,
                                   grid, bufs, out=g)
        out[f"mesh/{name}"] = (ghat.clone(), e.clone())
    g, e = (torch.from_numpy(x[rank].copy()) for x in mesh_inputs("float"))
    e0 = e.clone()
    cfg = CocoEFConfig(group_size=32, num_buckets=2)
    ghat = group_cocoef_update(g, e, torch.zeros(WORLD), MESH_GAMMA, cfg,
                               grids[1], group_buffers(cfg, 4, g.numel(),
                                                       "cpu"))
    out["straggle"] = (ghat.clone(), e0, e.clone())


def _train(rank, out):
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.mesh import coding_grid
    from repro_torch.launch.train import TrainRun, build_train_setup
    grid = coding_grid((WORLD,))
    s = build_train_setup(train_spec(), ShapeCfg("train", 32, 8),
                          TrainRun(base_lr=5e-3), smoke=True,
                          n_code=WORLD, device="cpu", group=grid)
    e = s.init_state()
    out["theta0"] = s.model.theta.clone()
    for t in range(TRAIN_STEPS):
        m = s.train_step(s.model, e, s.make_batch(t), t)
        out[f"loss{t}"] = m["loss"].item()
        out[f"theta{t + 1}"] = s.model.theta.clone()
    out["e"] = e.clone()


def _dtypes(rank, out):
    from _torch_cases import MESH_GAMMA, MESH_MASK, dtype_case, \
        dtype_case_names
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.cocoef import (CocoEFConfig, group_buffers,
                                         group_cocoef_update)
    from repro_torch.launch.mesh import coding_grid
    from repro_torch.launch.train import TrainRun, build_train_setup
    grids = {1: coding_grid((WORLD,)), 2: coding_grid((2, 2))}
    for name in dtype_case_names():
        axes, kw, g, e, gdt, edt = dtype_case(name)
        g = torch.from_numpy(g[rank].copy()).to(getattr(torch, gdt))
        e = torch.from_numpy(e[rank].copy()).to(getattr(torch, edt))
        cfg = CocoEFConfig(group_size=32, **kw)
        grid = grids[len(axes)]
        bufs = group_buffers(cfg, grid.nd, g.numel(), "cpu")
        ghat = group_cocoef_update(g, e if cfg.mode == "cocoef" else None,
                                   torch.tensor(MESH_MASK), MESH_GAMMA, cfg,
                                   grid, bufs)
        out[f"mesh/{name}"] = (ghat.clone(), e.clone())
    for comp in ("sign", "block_topk"):
        s = build_train_setup(
            train_spec(), ShapeCfg("train", 32, 8),
            TrainRun(base_lr=5e-3, compressor=comp, param_dtype="bfloat16",
                     ef_dtype="bfloat16"),
            smoke=True, n_code=WORLD, device="cpu", group=grids[1])
        e = s.init_state()
        for t in range(TRAIN_STEPS):
            m = s.train_step(s.model, e, s.make_batch(t), t)
            out[f"{comp}/loss{t}"] = m["loss"].item()
        out[f"{comp}/theta"] = s.model.theta.clone()
        out[f"{comp}/e"] = e.clone()


def _serve(rank, out):
    from repro_torch.launch.mesh import MeshLayout, process_mesh
    from _torch_cases import SHARD_CASES as CASES, run_sharded
    meshes = {}
    for arch, shape in CASES:
        if shape not in meshes:       # new_group is collective: one order
            meshes[shape] = process_mesh(MeshLayout(("data", "model"),
                                                    shape))
        out[f"{arch}/{shape}"] = run_sharded(arch, meshes[shape])


def _worker(rank, job, outdir, init):
    torch.set_num_threads(1)
    sys.path.insert(0, str(HERE))
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=WORLD)
    out = {}
    try:
        {"parity": _parity, "train": _train, "dtypes": _dtypes,
         "serve": _serve}[job](rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def start_gloo(job: str, outdir: Path) -> subprocess.Popen:
    """Start the 4 processes of `job`; `collect` waits for them."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, __file__, job, str(outdir)],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def collect(proc: subprocess.Popen, outdir: Path, timeout: int = 240):
    """Each rank's dict of a `start_gloo` run."""
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return [torch.load(outdir / f"rank{i}.pt", weights_only=False)
            for i in range(WORLD)]


def run_gloo(job: str, outdir: Path, timeout: int = 240):
    """Start the 4 processes of `job` once; returns each rank's dict."""
    return collect(start_gloo(job, outdir), outdir, timeout)


if __name__ == "__main__":
    job, outdir = sys.argv[1], sys.argv[2]
    mp.spawn(_worker, args=(job, outdir, os.path.join(outdir, "init")),
             nprocs=WORLD)
