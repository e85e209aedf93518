"""The JAX-run checks shared by tests/test_torch_wires.py (the dense wire
and dense mode) and tests/test_torch_topk.py (global top-K): each file
runs its own JAX runs through these, so the two files' runs go to two
workers.  `jax_mesh_cases` runs JAX's mesh stage 2 alone on the seeded
cases of `_torch_cases.MESH_CASES` (buckets, phase 2, 1-D and 2 x 2
grids) in one subprocess for tests/test_torch_parity.py.  The tolerances
are stated in each test file's docstring.  This module imports JAX;
tests/_torch_cases.py does not."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from _torch_cases import G, KB, LR, N, SRC, STEPS, _jax_run, _port_setup, \
    _state_dict
from repro.core import collectives as jcoll
from repro.core.plan import build_wire as jbuild_wire
from repro.kernels import ref as jref
from repro_torch.core.cocoef import cocoef_update

RUNS = {"identity": {"compressor": "identity"},
        "identity_bf16": {"compressor": "identity",
                          "wire_dtype": "bfloat16"},
        "identity_coco": {"compressor": "identity", "mode": "coco"},
        "topk": {"compressor": "topk"},
        "topk_coco": {"compressor": "topk", "mode": "coco"},
        "dense": {"mode": "dense"}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    x = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x.astype(np.int64)


def _equal(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


DUMPS = {}


def dump(tmp_path_factory, name):
    """JAX's dump of run `name`, with its mesh stage 2 (made once)."""
    if name not in DUMPS:
        DUMPS[name] = _jax_run(tmp_path_factory,
                                {**RUNS[name], "mesh_stage2": True})
    return DUMPS[name]


def _e_in(ref_, t, n):
    return np.zeros((N, n), np.float32) if t == 0 else ref_[f"e{t}"]


def setup_matches_jax(name, kw, ref_):
    s = _port_setup(**kw)
    n = s.flat_pad
    assert n == int(ref_["flat_pad"]) == 164_480
    assert s.cocoef_cfg.pad_multiple == G               # not lcm(G, B)
    np.testing.assert_array_equal(s.W, ref_["W"])
    s.model.load_params(_state_dict(ref_))
    np.testing.assert_array_equal(s.model.theta.numpy(), ref_["theta0"])
    if name.startswith("topk"):
        idx, val, sc = s.payload
        assert idx.shape == val.shape == (N, N, KB)       # one block a chunk
        assert idx.dtype == torch.uint16 and sc.shape == (N, N)
        assert s.cocoef_cfg.wire_format(n, N).block_size == n // N
    else:                                    # the ghat accumulator only
        (acc,) = s.payload
        assert acc.shape == (n,) and acc.dtype == torch.float32
    e = s.init_state()
    if kw.get("mode", "cocoef") == "cocoef":
        assert e.shape == (N, n)
    else:                                    # never read: not allocated
        assert e is None
        for t in range(1, STEPS + 1):
            assert not ref_[f"e{t}"].any()


def _jax_stage2(name, kw, g, e_in, mask, n):
    """JAX's stage 2 from its references, composed as its cocoef_update
    does (`repro/core/cocoef.py:278-326`) on one rank after another, then
    the sender-order decode.  Returns (payload leaves stacked over ranks
    as numpy, or None for dense, e', ghat)."""
    mode = kw.get("mode", "cocoef")
    gam = jnp.float32(LR)
    if mode == "dense":
        acc = [gam * jnp.asarray(g[i]) for i in range(N)]
        ghat = jnp.zeros(n, jnp.float32)
        for i in range(N):
            ghat = ghat + jnp.float32(mask[i]) * acc[i]
        return None, e_in, np.asarray(ghat)
    jw = jbuild_wire(kw["compressor"], value_dtype=kw.get("wire_dtype",
                                                          "float32"),
                     n=n, nd=N)
    leaves, e_new = [], []
    for i in range(N):
        gi, ei = jnp.asarray(g[i]), jnp.asarray(e_in[i])
        if mode == "coco":
            p = jw.pack(gam * gi)
            e_new.append(e_in[i])
        elif isinstance(jw, jcoll.DenseWire):
            p, _, en = jw.fused_local_step(gi, ei, gam, jnp.float32(mask[i]))
            e_new.append(np.asarray(en))
        else:
            idx, val, sc, _, en = jref.ef_topk_fused_ref(
                gi, ei, gam, jnp.float32(mask[i]), jw.k_max, jw.block_size)
            p = (idx.astype(jw.index_dtype), val, sc)
            e_new.append(np.asarray(en))
        leaves.append(p)
    stacked = [jnp.stack([p[j] for p in leaves])
               for j in range(len(leaves[0]))]
    if isinstance(jw, jcoll.DenseWire):
        ghat = jref.dense_decode_reduce_scan(stacked[0], jnp.asarray(mask))
    else:
        ghat = jref.topk_decode_reduce_scan(
            stacked[0].astype(jnp.int32), stacked[1].astype(jnp.float32),
            stacked[2], jnp.asarray(mask), jw.block_size)
    return ([np.asarray(x) for x in stacked], np.stack(e_new),
            np.asarray(ghat))


def stage2_with_jax_gradients(name, kw, ref_):
    """JAX's stage-1 gradients and state at the start of each step go into
    the port's stage 2; against JAX's references on the same inputs, then
    against JAX's mesh stage 2 (tolerances in the module docstring)."""
    s = _port_setup(**kw)
    cfg, n = s.cocoef_cfg, s.flat_pad
    mode = cfg.mode
    for t in range(STEPS):
        theta = ref_[f"theta{t}"]
        e_in = _e_in(ref_, t, n)
        e = _t(e_in)
        g, mask = ref_[f"g{t}"], ref_[f"mask{t}"]
        payload = tuple(torch.zeros_like(p) for p in s.payload)
        ghat = cocoef_update(lambda i: _t(g[i]), e, _t(mask), LR, cfg,
                             payload).numpy()
        want_p, want_e, jghat = _jax_stage2(name, kw, g, e_in, mask, n)
        if mode != "cocoef":
            _equal(e, e_in)                          # e neither read nor
        if want_p is None or cfg.folds:              # written
            _equal(e, want_e)
            _equal(ghat, jghat)
            _equal(theta - ghat, theta - jghat)
        else:                                        # topk
            acc = (np.float32(LR) * g + (e_in if mode == "cocoef" else 0)
                   ).astype(np.float32)
            tiny = np.finfo(np.float32).tiny     # XLA:CPU flushes them (C6)
            for x in (acc, e.numpy()):
                assert not ((x != 0) & (np.abs(x) < tiny)).any()
            for j in range(3):
                _equal(payload[j].to(torch.float32 if j else torch.int64),
                       want_p[j].astype(np.float32 if j else np.int64))
            _equal(e, want_e)
            _equal(ghat, jghat)
            _equal(theta - ghat, theta - jghat)
        if mode == "dense":                  # the rank-order sum from +0
            acc = (np.float32(LR) * g).astype(np.float32)
            want = np.zeros(n, np.float32)
            for i in range(N):
                want = want + np.float32(mask[i]) * acc[i]
            _equal(ghat, want)

        # against JAX's mesh stage 2 (every rank holds the same ghat)
        mg, me = ref_[f"s2_ghat{t}"], ref_[f"s2_e{t}"]
        for i in range(N):
            _equal(mg[i], mg[0])
        if name in ("identity_bf16", "topk"):
            # the FMA skips the rounding of gamma*g: up to an ulp of it,
            # then acc's own
            gg = (np.float32(LR) * g).astype(np.float32)
            acc = gg + e_in
            ulp = np.spacing(np.abs(acc)) + np.spacing(np.abs(gg))
            if name == "identity_bf16":
                fma = (np.float64(np.float32(LR)) * g.astype(np.float64)
                       + e_in.astype(np.float64)).astype(np.float32)
                c = torch.from_numpy(fma).to(torch.bfloat16).float().numpy()
                live = mask > 0
                _equal(me[live], (fma - c)[live])         # XLA's FMA form
                assert np.all(np.abs(e.numpy() - me)
                              <= ulp + 2.0 ** -7 * np.abs(acc))
                tol = (ulp + 2.0 ** -7 * np.abs(acc)).sum(0)
                assert np.all(np.abs(ghat - mg[0]) <= tol + np.spacing(
                    np.abs(ghat)) * N)
            else:
                # off the two kept sets (at most 2 * KB a chunk) e' = acc
                off = np.abs(e.numpy() - me) > ulp
                assert off.reshape(N, N, -1).sum(-1).max() <= 2 * KB
                flip = N * float(payload[2].max()) + 1e-6
                assert np.abs(ghat - mg[0]).max() <= flip
                assert np.abs(e.numpy() - me).max() <= flip
        else:
            _equal(ghat, mg[0])                      # C5 on dense mode
            _equal(e, me)
        flip = N * float(payload[-1].max()) if name == "topk" else 0.0
        if name == "identity_bf16":
            flip = N * 2.0 ** -7 * LR * float(np.abs(g).max())
        assert np.abs(theta - ghat - ref_[f"theta{t + 1}"]).max() <= \
            flip + 1e-6


def end_to_end_matches_jax(name, kw, ref_):
    """The port's whole step (its own stage 1 from the converted params,
    JAX's batches and masks) for 3 steps (tolerances in the module
    docstring)."""
    s = _port_setup(**kw)
    s.model.load_params(_state_dict(ref_))
    e = torch.zeros((N, s.flat_pad)) if s.cocoef_cfg.mode == "cocoef" \
        else None
    max_scale, max_g = 0.0, 0.0
    for t in range(STEPS):
        batch = (torch.from_numpy(ref_[f"tokens{t}"]).long(),
                 torch.from_numpy(ref_[f"weights{t}"]))
        m = s.train_step(s.model, e, batch, t,
                         masks=torch.from_numpy(ref_[f"mask{t}"]))
        np.testing.assert_allclose(m["loss"].item(), ref_[f"loss{t}"],
                                   rtol=1e-4)
        max_g = max(max_g, float(np.abs(ref_[f"g{t}"]).max()))
        if name.startswith("topk"):
            max_scale = max(max_scale, s.payload[2].max().item())
            bound = (t + 1) * N * max_scale
        elif name == "identity_bf16":
            bound = (t + 1) * N * 2.0 ** -7 * LR * max_g
        else:
            bound = (t + 1) * 1e-6
        d = np.abs(s.model.theta.numpy() - ref_[f"theta{t + 1}"])
        assert d.max() <= bound
        assert np.mean(d > 1e-6) < 0.01
        if e is not None:
            assert np.abs(e.numpy() - ref_[f"e{t + 1}"]).max() <= bound


def step_parity_cpu_against_cpu(name):
    """The card-versus-CPU check of run `name`, with the CPU on both
    sides: bit for bit."""
    from repro_torch.launch.device_parity import step_parity
    kw = dict(RUNS[name])
    out = step_parity("cpu", compressor=kw.pop("compressor", "sign"), **kw)
    assert out["max_abs_dtheta"] == 0.0 and out["loss_cpu"] == \
        out["loss_device"]


MESH_RUN = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import warnings
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, sys.argv[2])
    from _torch_cases import (MESH_CASES, MESH_GAMMA, MESH_MASK,
                              mesh_inputs)
    from repro.compat import make_mesh, shard_map
    from repro.core.cocoef import CocoEFConfig, cocoef_update
    warnings.simplefilter("ignore")
    out = {}
    for name in sys.argv[3].split(","):
        axes, kw, kind = MESH_CASES[name]
        shape = (4,) if len(axes) == 1 else (2, 2)
        mesh = make_mesh(shape, axes)
        spec = P(axes if len(axes) > 1 else axes[0])
        cfg = CocoEFConfig(coding_axes=axes, group_size=32, backend="jnp",
                           **kw)

        def s2(g, e, mask, cfg=cfg):
            gh, en = cocoef_update(g.reshape(-1), e.reshape(-1), mask,
                                   jnp.float32(MESH_GAMMA), cfg)
            return gh.reshape(1, -1), en.reshape(1, -1)
        f = jax.jit(shard_map(s2, mesh, in_specs=(spec, spec, P()),
                              out_specs=(spec, spec), check=False))
        g, e = mesh_inputs(kind)
        gh, en = f(g, e, np.asarray(MESH_MASK, np.float32))
        out[name + "/ghat"] = np.asarray(gh)
        out[name + "/e"] = np.asarray(en)
    np.savez(sys.argv[1], **out)
""")


def jax_mesh_cases(tmp_path_factory, names):
    """JAX's mesh `cocoef_update` (jnp backend, a shard_map over 4 host
    devices) on the seeded inputs of `_torch_cases.MESH_CASES`, every case
    in one subprocess: {name: (ghat (4, n), e' (4, n))}, one row per
    device (coding rank, row-major over the grid)."""
    path = tmp_path_factory.mktemp("jax_mesh") / "mesh.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", MESH_RUN, str(path),
                        str(Path(__file__).parent), ",".join(names)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = dict(np.load(path))
    return {n: (got[n + "/ghat"], got[n + "/e"]) for n in names}
