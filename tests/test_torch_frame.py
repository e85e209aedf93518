"""The train step's telemetry frame (`TrainRun(metrics=True)`,
`core/cocoef.py::FrameSums`, `optim.apply_update(want_norms=True)`,
`obs/metrics.py`) against JAX's `want_metrics=True` step, and the
`metrics=False` step unchanged.

JAX's real 4-device train step with `TrainRun(metrics=True)` runs in one
subprocess for six runs (sign; block top-K with per-rank budgets; coco;
dense mode; block top-K with bf16 error vectors, with f32 and with bf16
parameters) and dumps each step's parameters, error vectors (bf16 ones as
their f32 values), per-rank gradients, mask and telemetry.  The port's stage 2 and server update
(`TrainSetup.coded_update`) then run on the same theta, e, gradients and
mask, and its frame is compared field by field.

Tolerances: participation, participants, the wire bytes and bytes_down
exact.  The norms, cosines and contractions within rtol 1e-4 (atol 1e-5
for the cosine and contraction, which are 1 and 0 on the dense paths):
XLA sums in f32 in its own order (ROADMAP C3) and contracts gamma*g + e
into an FMA inside the mesh step (C12), the port sums f32 chunk sums in
float64; a few f32 ulps, well inside the tolerance.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_cases import G, LR, N, SRC, _port_setup
from _torch_cases import one_thread_module  # noqa: F401 (autouse)
from repro_torch.kernels import sign_pack as sp, topk_pack as tp

RUNS = {
    "sign": {},
    "block_topk_budgets": {"compressor": "block_topk",
                           "k_budgets": [8, 8, 4, 2]},
    "coco": {"mode": "coco"},
    "dense": {"mode": "dense"},
    "block_topk_bf16_e": {"compressor": "block_topk",
                          "ef_dtype": "bfloat16"},
    "block_topk_budgets_bf16": {"compressor": "block_topk",
                                "k_budgets": [8, 8, 4, 2],
                                "param_dtype": "bfloat16",
                                "ef_dtype": "bfloat16"},
}
STEPS_F = 2
EXACT = ("participation", "participants", "wire_bytes_rank",
         "bytes_up_total", "bucket_wire_bytes_rank", "bytes_down")
FLOAT = ("grad_norm_rank", "ef_norm_rank", "compress_cosine_rank",
         "compress_contraction_rank", "ghat_norm", "update_norm",
         "param_norm")

JAX_FRAMES = textwrap.dedent(f"""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, math, warnings
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.configs import REGISTRY
    from repro.configs.common import ShapeCfg
    from repro.core.cocoef import flatten_local
    from repro.launch.train import (TrainRun, build_train_setup,
                                    make_batch_for_step)
    warnings.simplefilter("ignore")
    spec = REGISTRY["gemma2-2b"]
    spec = dataclasses.replace(
        spec, smoke=dataclasses.replace(spec.smoke, dtype="float32"),
        coding=dataclasses.replace(spec.coding, group_size={G}))
    mesh = make_mesh((4, 1), ("data", "model"))
    shape = ShapeCfg("train", 32, 8)
    out = {{}}
    for name, kw in json.loads(sys.argv[2]).items():
        if "k_budgets" in kw:
            kw["k_budgets"] = tuple(kw["k_budgets"])
        pad = (math.lcm({G}, spec.coding.block_size)
               if kw.get("compressor") == "block_topk" else {G})
        setup = build_train_setup(spec, mesh, shape,
                                  TrainRun(base_lr={LR}, metrics=True, **kw),
                                  smoke=True)
        key = jax.random.PRNGKey(0)
        params, e, opt = setup.init_state(key)
        flat = lambda leaves: np.asarray(flatten_local(leaves, 4, pad)[0])
        model = setup.model
        grads = jax.jit(lambda p, b: jax.vmap(
            lambda bb: jax.grad(lambda q: model.loss(q, bb)[0])(p))(b))
        step = jax.jit(setup.train_step)
        for t in range({STEPS_F}):
            batch = make_batch_for_step(setup, spec, shape, key, t,
                                        smoke=True)
            g = grads(params, batch)
            pre = f"{{name}}/{{t}}/"
            out[pre + "theta"] = flat(jax.tree.leaves(params))
            out[pre + "e"] = np.asarray(e.astype(jnp.float32)).reshape(
                4, -1)
            out[pre + "g"] = np.stack([flat([l[i] for l in
                                             jax.tree.leaves(g)])
                                       for i in range(4)])
            params, e, opt, m = step(params, e, opt, batch, jnp.int32(t),
                                     key)
            for k, v in m["telemetry"].items():
                out[pre + "tel/" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_frames") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", JAX_FRAMES, str(path),
                        json.dumps(RUNS)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


def _kw(name):
    kw = dict(RUNS[name])
    if "k_budgets" in kw:
        kw["k_budgets"] = tuple(kw["k_budgets"])
    return kw


def _port_frame(setup, ref, pre, step):
    """The port's stage 2 + update on JAX's theta, e, gradients and mask
    of one step; returns the reduced frame and the step's ghat."""
    m = setup.model
    m.theta.zero_()
    m.theta[:ref[pre + "theta"].size].copy_(
        torch.from_numpy(ref[pre + "theta"]))
    e = None
    if setup.cocoef_cfg.mode == "cocoef":
        e = torch.from_numpy(ref[pre + "e"].copy()).to(
            getattr(torch, setup.run.ef_dtype))
    grads = torch.from_numpy(ref[pre + "g"])

    def grad_of(i):
        m.grad.copy_(grads[i])
        return m.grad
    mask = torch.from_numpy(ref[pre + "tel/participation"].astype(np.float32))
    frames = []
    setup.coded_update(m, grad_of, e, mask, step, frames=frames)
    from repro_torch.obs.metrics import frame_to_host, reduce_frame
    return frame_to_host(reduce_frame(frames[0]))


@pytest.mark.parametrize("name", list(RUNS))
def test_frame_equals_jax(jax_frames, name):
    setup = _port_setup(metrics=True, **_kw(name))
    assert setup.flat_pad == jax_frames[f"{name}/0/theta"].size
    for t in range(STEPS_F):
        pre = f"{name}/{t}/"
        got = _port_frame(setup, jax_frames, pre, t)
        for k in EXACT:
            want = jax_frames[pre + "tel/" + k]
            np.testing.assert_array_equal(np.asarray(got[k]), want,
                                          err_msg=f"{name} {t} {k}")
        for k in FLOAT:
            want = jax_frames[pre + "tel/" + k].astype(np.float64)
            atol = 1e-5 if "compress" in k else 0.0
            np.testing.assert_allclose(np.asarray(got[k]), want, rtol=1e-4,
                                       atol=atol, err_msg=f"{name} {t} {k}")


@pytest.mark.parametrize("name", list(RUNS))
def test_metrics_off_leaves_the_step_alone(name):
    """metrics=False and True give the same theta and e bits and launch
    the same kernels (counted by the wrappers; none on the CPU, and the
    plain versions run the same number of times)."""
    out = {}
    for metrics in (False, True):
        s = _port_setup(metrics=metrics, straggler="markov", **_kw(name))
        e = s.init_state()
        before = dict(sp.launches), dict(tp.launches)
        for t in range(2):
            res = s.train_step(s.model, e, s.make_batch(t), t)
        assert ("telemetry" in res) == metrics
        out[metrics] = (s.model.theta.clone(),
                        None if e is None else e.clone(),
                        (dict(sp.launches), dict(tp.launches)), before)
    (t0, e0, l0, b0), (t1, e1, l1, b1) = out[False], out[True]
    assert torch.equal(t0, t1)
    assert (e0 is None and e1 is None) or torch.equal(e0, e1)
    assert l0 == b0 and l1 == b1          # the CPU launches no kernel
