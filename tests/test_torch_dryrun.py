"""The port's dry run (`repro_torch.launch.dryrun`, `op_cost`, `roofline`)
against JAX's (`repro.launch.dryrun`, `hlo_cost`, `hlo_analysis`).

  - shard bytes: every argument part's per-device bytes from
    `train_specs` / `serve_specs` equal the shard shapes of JAX's
    `input_specs` exactly, leaf by leaf, on the production meshes.  JAX's
    side comes from one subprocess with 512 host devices that builds the
    setups and writes the shard shapes (no lowering), once per module,
    beside the two compiling subprocesses below;
  - dot flops: the counter's dot flops of one coding rank's stage 1 on
    the meta device equal `hlo_cost.analyze(...).flops` of JAX's compiled
    smoke step on a one-device mesh (n_code 1: the step is stage 1 and a
    dense stage 2 with no dot) for gemma2-2b, olmoe-1b-7b and xlstm-1.3b.
    Tolerance: none, the counts are equal.  Both count every dot of the
    forward, the remat's recompute and the backward at 2 * prod(result) *
    prod(contracting); JAX's remat (`nothing_saveable`) recomputes what
    `torch.utils.checkpoint` recomputes, and the sLSTM's and the
    router's f32 dots are dots on both sides;
  - trip counts: the loop shortcut (`common.trips` on the meta device)
    gives the unrolled counts exactly;
  - wire bytes: the coded collective's calls on a dry grid equal the
    all-to-all and all-gather entries of `hlo_analysis.parse_collectives`
    of JAX's compiled smoke step on a (data=4, model=1) mesh;
  - roofline: `roofline_terms` given JAX's TPU constants equals JAX's;
  - the CLI: a record with JAX's keys, the cache read back, a skipped
    cell's reason.

JAX's three subprocesses (the shard shapes, the flops steps, the wire
step) start together when the first case needs one; the cases that
wait for a compile come last in the module.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_cases import SRC, one_thread
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.launch import hlo_analysis
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.kernels import common, cost
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import MeshLayout, make_production_mesh
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.train import TrainRun, build_train_setup

CELLS = [("gemma2-2b", "train_4k", False), ("gemma2-2b", "train_4k", True),
         ("qwen1.5-110b", "train_4k", True),
         ("olmoe-1b-7b", "train_4k", False),
         ("xlstm-1.3b", "train_4k", False),
         ("llava-next-34b", "prefill_32k", False),
         ("phi3-medium-14b", "decode_32k", False),
         ("gemma2-2b", "long_500k", False)]
FLOPS_ARCHS = ("gemma2-2b", "olmoe-1b-7b", "xlstm-1.3b")

JAX_SPECS = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import warnings
    import jax, numpy as np
    from repro.configs import REGISTRY
    from repro.launch.mesh import make_production_mesh
    from repro.launch.serve import build_serve_setup
    from repro.launch.train import TrainRun, build_train_setup
    warnings.simplefilter("ignore")

    def leaves(tree):
        out = {}
        for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in p)
            s = l.sharding.shard_shape(l.shape) if l.sharding else l.shape
            out[name] = [list(s), np.dtype(l.dtype).itemsize]
        return out

    res = {}
    for arch, shp, mp in json.loads(sys.argv[2]):
        spec = REGISTRY[arch]
        shape = spec.shapes[shp]
        mesh = make_production_mesh(multi_pod=mp)
        if shape.is_train:
            s = build_train_setup(spec, mesh, shape, TrainRun())
            sp = s.input_specs()
            info = {"n_code": s.n_code, "b_loc": s.b_loc,
                    "flat_pad": s.flat_pad,
                    "effective_mode": s.cocoef_cfg.mode}
        else:
            s = build_serve_setup(spec, mesh, shape)
            sp = s.input_specs("decode" if shape.kind == "decode"
                               else "prefill")
            info = {"cache_len": s.cache_len}
        info["parts"] = {k: leaves(v) for k, v in sp.items()}
        res[f"{arch}/{shp}/{mp}"] = info
    json.dump(res, open(sys.argv[1], "w"))
""")

JAX_COSTS = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import warnings
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import REGISTRY
    from repro.configs.common import SMOKE_TRAIN
    from repro.launch import hlo_analysis, hlo_cost
    from repro.launch.train import TrainRun, build_train_setup
    warnings.simplefilter("ignore")

    def compiled(arch, shape):
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        s = build_train_setup(REGISTRY[arch], mesh, SMOKE_TRAIN, TrainRun(),
                              smoke=True)
        sp = s.input_specs()
        c = jax.jit(s.train_step).lower(
            sp["params"], sp["e"], sp["opt"], sp["batch"], sp["step"],
            sp["key"]).compile()
        return s, c.as_text()

    res = {}
    archs = json.loads(sys.argv[2])
    if archs:
        for arch in archs:
            s, txt = compiled(arch, (1, 1))
            res[arch] = {"flops": hlo_cost.analyze(txt, 1).flops,
                         "n_code": s.n_code, "b_loc": s.b_loc}
    else:
        s, txt = compiled("gemma2-2b", (4, 1))
        res = {"flat_pad": s.flat_pad,
               "ops": hlo_analysis.parse_collectives(txt, 4).ops}
    json.dump(res, open(sys.argv[1], "w"))
""")


class _JaxRefs:
    """JAX's dumps by name ("specs", "flops", "wire"), each from its own
    subprocess; all three start at once, and `[name]` waits for one."""

    def __init__(self, tmp):
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        self.runs, self.out = {}, {}
        for key, script, arg in (("specs", JAX_SPECS, CELLS),
                                 ("flops", JAX_COSTS, list(FLOPS_ARCHS)),
                                 ("wire", JAX_COSTS, [])):
            path = tmp / f"{key}.json"
            self.runs[key] = (path, subprocess.Popen(
                [sys.executable, "-c", script, str(path), json.dumps(arg)],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))

    def __getitem__(self, key):
        if key not in self.out:
            path, proc = self.runs[key]
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            self.out[key] = json.loads(path.read_text())
        return self.out[key]

    def close(self):
        for _, proc in self.runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """JAX's three dumps, started together once per module."""
    refs = _JaxRefs(tmp_path_factory.mktemp("jax_dryrun"))
    yield refs
    refs.close()


def _port_leaves(part):
    """{'/'-joined path: [shard shape, itemsize]} of a part of `Arg`s (the
    names JAX's key paths give)."""
    if isinstance(part, dryrun.Arg):
        return {"": [list(part.shard), dryrun._ITEMSIZE[part.dtype]]}
    items = (sorted(part.items()) if isinstance(part, dict)
             else enumerate(part))
    out = {}
    for k, v in items:
        for sub, leaf in _port_leaves(v).items():
            out["/".join(x for x in (str(k), sub) if x)] = leaf
    return out


@pytest.mark.parametrize("arch,shape,multi", CELLS,
                         ids=[f"{a}-{s}-{'multi' if m else 'single'}"
                              for a, s, m in CELLS])
def test_shard_bytes_equal_jax(jax_refs, arch, shape, multi):
    """Per-device bytes of every part, and every leaf's shard shape and
    itemsize, equal JAX's `input_specs`; so do n_code, b_loc, flat_pad,
    the effective mode and cache_len."""
    want = jax_refs["specs"][f"{arch}/{shape}/{multi}"]
    spec, mesh = REGISTRY[arch], make_production_mesh(multi_pod=multi)
    shp = spec.shapes[shape]
    if shp.is_train:
        got = dryrun.train_specs(spec, shp, mesh)
        for k in ("n_code", "b_loc", "flat_pad", "effective_mode"):
            assert got[k] == want[k], k
    else:
        got = dryrun.serve_specs(spec, shp, mesh, "decode" if shp.kind ==
                                 "decode" else "prefill")
        assert got["cache_len"] == want["cache_len"]
    parts = got["parts"]
    assert set(parts) == set(want["parts"])
    by_part = dryrun.part_bytes(parts)
    for name, leaves in want["parts"].items():
        assert _port_leaves(parts[name]) == leaves, name
        assert by_part[name] == sum(int(np.prod(s)) * b
                                    for s, b in leaves.values()), name


def _mlstm_chunks(short: bool) -> OpCounter:
    """xlstm's chunkwise mLSTM scan alone (4 chunks of 16) on the meta
    device, autograd off, as a prefill runs it."""
    from repro_torch.nn import xlstm as XL
    B, S, H, hd = 2, 64, 4, 8
    q, k, v = (torch.empty((B, S, H, hd), device="meta") for _ in range(3))
    ig, lf = (torch.empty((B, S, H), device="meta") for _ in range(2))
    state = XL.mlstm_state(B, H, hd, "meta")
    with torch.no_grad(), OpCounter(short) as c:
        XL.mlstm_chunk_scan(q, k, v, ig, lf, state, chunk=16)
    return c


@pytest.mark.parametrize("case,taken", [
    ("xlstm-1.3b train", True), ("xlstm-1.3b mlstm", True),
    ("zamba2-2.7b train", False), ("zamba2-2.7b prefill", True)])
def test_loop_shortcut_equals_unrolled(case, taken):
    """With the loop shortcut a count equals the unrolled one: xlstm's
    smoke stage 1 at seq 32 (the sLSTM's steps both ways take it), the
    mLSTM's chunk scan with autograd off (its 4 chunks), zamba2's smoke
    stage 1 (its SSD carries run under autograd: not taken) and prefill
    at 512 (the SSD's 7 chunk carries)."""
    arch, what = case.split()
    cfg = REGISTRY[arch].smoke

    def count(short):
        if what == "train":
            return dryrun.stage1_count(cfg, 4, 32, loop_shortcut=short)
        if what == "mlstm":
            return _mlstm_chunks(short)
        return dryrun.serve_count(cfg, "prefill", 4, 512, 512,
                                  loop_shortcut=short)
    with one_thread():
        short, full = count(True), count(False)
    assert short.dot_flops == full.dot_flops and short.flops > 0
    assert short.bytes_eager == full.bytes_eager
    assert short.kernels == full.kernels
    assert short.dispatches == full.dispatches == full.seen
    assert (short.seen < full.seen) == taken


def test_roofline_equals_jax():
    """`roofline_terms` with JAX's TPU constants passed in equals JAX's
    `hlo_analysis.roofline_terms`; the ring factors and dtype sizes are
    JAX's."""
    rng = np.random.default_rng(0)
    for f, b, w in rng.uniform(0, 1e13, (6, 3)).tolist() + [[0, 0, 0]]:
        got = roofline.roofline_terms(f, b, w,
                                      peak_flops=hlo_analysis.PEAK_FLOPS,
                                      hbm_bw=hlo_analysis.HBM_BW,
                                      link_bw=hlo_analysis.ICI_BW)
        assert got == hlo_analysis.roofline_terms(f, b, w)
    assert roofline.DTYPE_BYTES == hlo_analysis._DTYPE_BYTES
    for op, fn in hlo_analysis._WIRE_FACTOR.items():
        assert [roofline.WIRE_FACTOR[op](g) for g in (1, 2, 16)] == \
            [fn(g) for g in (1, 2, 16)]
    by_dt = roofline.roofline_terms({"bfloat16": 989e12, "float32": 67e12},
                                    0, 0, peak_flops=roofline.PEAK_FLOPS)
    assert by_dt["compute_s"] == 2.0


def test_meta_step_counts_equal_cpu_step():
    """The port's whole one-device train step (smoke gemma2-2b, sign, N =
    4) on the meta device dispatches the dot flops the CPU step does, and
    charges B1 four times and B2 once there (the CPU runs the plain
    versions: no charge); no kernel launch is counted on either."""
    spec = REGISTRY["gemma2-2b"]
    shape = ShapeCfg("train", 32, 8)
    counts = {}
    with one_thread():
        for dev in ("cpu", "meta"):
            setup = build_train_setup(spec, shape, TrainRun(), smoke=True,
                                      device=dev)
            e = setup.init_state() if dev == "cpu" else torch.zeros(
                (setup.n_code, setup.flat_pad), device=dev)
            batch = setup.batch_to_device(setup.host_batch(0))
            before = dict(common.launches)
            with OpCounter() as c:
                setup.train_step(setup.model, e, batch, 0)
            assert common.launches == before
            counts[dev] = c
    assert counts["meta"].dot_flops == counts["cpu"].dot_flops
    assert counts["cpu"].kernels == {}
    n = setup.flat_pad
    k = counts["meta"].kernels
    assert set(k) == {"ef_sign_fused", "sign_decode_reduce"}
    assert k["ef_sign_fused"]["launches"] == 4
    assert k["ef_sign_fused"]["bytes"] == 4 * cost.ef_sign_fused(n, 512).bytes
    assert k["sign_decode_reduce"] == {
        "launches": 1, "bytes": cost.sign_decode_reduce(4, n, 512).bytes,
        "ops": cost.sign_decode_reduce(4, n, 512).ops,
        "ops_dtype": "float32"}


def test_meta_wrappers_shape_and_charge():
    """On the meta device each wrapper returns the kernel's outputs'
    shapes and dtypes and charges `kernels.cost`'s bill; the flash
    wrapper too (B8 at a gemma2 layer's shape)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sign_pack as sp
    from repro_torch.kernels import topk_pack as tp
    dev, n = torch.device("meta"), 1 << 20
    g = torch.empty(n, device=dev)
    e = torch.empty(n, dtype=torch.bfloat16, device=dev)
    q = torch.empty((2, 8, 4096, 288), dtype=torch.bfloat16, device=dev)
    kv = torch.empty((2, 4, 4096, 288), dtype=torch.bfloat16, device=dev)
    with OpCounter() as c:
        w, s, _, en = sp.ef_sign_fused(g, e, 0.1, 1.0, 512)
        i, v, sc, _, en2 = tp.ef_topk_fused(g, e, 0.1, 1.0, 8, 256)
        tp.topk_pack(e, 8, 256, gamma=0.1)
        tp.topk_decode_reduce(i[None].expand(3, -1, -1).contiguous(),
                              v[None].expand(3, -1, -1).contiguous(),
                              sc[None].expand(3, -1).contiguous(),
                              torch.ones(3, device=dev), 256)
        o = fa.flash_attention(q, kv, kv, softcap=50.0, window=4096,
                               groups=2)
    assert (w.shape, w.dtype, s.shape, en.dtype) == (
        (n // 32,), torch.uint32, (n // 512,), torch.bfloat16)
    assert (i.shape, i.dtype, v.dtype, en2.dtype) == (
        (n // 256, 8), torch.uint16, torch.float32, torch.bfloat16)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    bills = {"ef_sign_fused": cost.ef_sign_fused(n, 512, 4, 2),
             "ef_topk_fused": cost.ef_topk_fused(n, 256, 8, 4, 2),
             "topk_pack": cost.topk_pack(n, 256, 8, 2, gamma=True),
             "topk_decode_reduce": cost.topk_decode_reduce(3, n, 256, 8),
             "flash_attention": cost.flash_attention(2, 8, 4, 4096, 288,
                                                     4096, 2)}
    assert {k: (v["launches"], v["bytes"], v["ops"], v["ops_dtype"])
            for k, v in c.kernels.items()} == {
        k: (1, b.bytes, b.ops, b.ops_dtype) for k, b in bills.items()}
    assert bills["flash_attention"].ops_dtype == "bfloat16"


def test_cli_record_cache_and_skip(tmp_path, monkeypatch, capsys):
    """`main` writes a record with JAX's keys, a second run reads the
    cache, and a skipped cell records JAX's reason."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    args = ["--arch", "gemma2-2b", "--shape", "long_500k", "--mesh",
            "single"]
    with one_thread():
        dryrun.main(args)
    rec = json.loads(dryrun.cell_path("gemma2-2b", "long_500k",
                                      "single").read_text())
    assert rec["status"] == "ok"
    for key in ("arch", "shape", "mesh", "mode", "cache_len", "memory",
                "roofline", "total_s"):
        assert key in rec, key
    assert rec["cache_len"] == 4096
    assert rec["memory"]["argument_bytes"] == sum(
        rec["memory"]["by_part"].values())
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "bound_s",
                                    "roofline_fraction"}
    capsys.readouterr()
    dryrun.main(args)
    assert "[cached] gemma2-2b long_500k single: ok" in capsys.readouterr().out
    rec = dryrun.run_cell("qwen1.5-110b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == JAX_REGISTRY["qwen1.5-110b"].skip_shapes[
        "long_500k"]


def test_wire_bytes_equal_parse_collectives(jax_refs):
    """gemma2-2b's smoke step on (data=4, model=1): one device's stage 2
    on a dry grid records the all-to-alls (sign words, scales) and the
    phase-2 all-gather JAX's compiled step holds, byte for byte."""
    mesh = MeshLayout(("data", "model"), (4, 1))
    tr = dryrun.train_specs(REGISTRY["gemma2-2b"], ShapeCfg("train", 32, 8),
                            mesh, smoke=True)
    wire = jax_refs["wire"]
    assert tr["flat_pad"] == wire["flat_pad"]
    with one_thread():
        counter, calls = dryrun.stage2_count(tr)
    want = sorted((o["op"], o["result_bytes"], o["group"], o["wire_bytes"])
                  for o in wire["ops"]
                  if o["op"] in ("all-to-all", "all-gather"))
    got = sorted((c["op"], c["result_bytes"], c["group"],
                  roofline.wire_bytes(c["op"], c["result_bytes"],
                                      c["group"])) for c in calls)
    assert got == want
    n = tr["flat_pad"]
    assert counter.kernels["ef_sign_fused"] == {
        "launches": 1, "bytes": cost.ef_sign_fused(n, 512).bytes,
        "ops": cost.ef_sign_fused(n, 512).ops, "ops_dtype": "float32"}
    assert counter.kernels["sign_decode_reduce"]["bytes"] == \
        cost.sign_decode_reduce(4, n // 4, 512).bytes


@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_dot_flops_equal_hlo_cost(jax_refs, arch):
    """One rank's stage 1 at JAX's smoke (b_loc, seq) = (8, 32), counted
    on the meta device, equals hlo_cost's flops of JAX's compiled step
    exactly (see the module docstring)."""
    want = jax_refs["flops"][arch]
    assert want["n_code"] == 1
    with one_thread():
        c = dryrun.stage1_count(REGISTRY[arch].smoke, want["b_loc"], 32)
    assert c.flops == want["flops"]
