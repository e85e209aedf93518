"""Inputs, comparisons and the JAX reference harness shared by the port's
tests.  Nothing here imports JAX (the harness runs it in a subprocess), so
the GPU tests, which run without JAX, can use this module too."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.launch.train import TrainRun, build_train_setup


@contextlib.contextmanager
def one_thread():
    """torch on one CPU thread inside: smoke-size steps gain nothing from
    more, and under the suite's parallel workers every OpenMP barrier of
    a many-thread process waits for descheduled threads (a driver resume
    test took 600-800 s that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def one_thread_module():
    """`one_thread` around a whole test module: import it there (pytest
    finds an autouse fixture among a module's names)."""
    with one_thread():
        yield


def ef_inputs(n: int, group_size: int, seed: int, denormals: bool = True):
    """(g, e) f32 of length n with adversarial groups first: all zeros,
    -0.0 everywhere, denormals (or, with denormals=False, the smallest
    normal numbers), exact cancellation to +0 (g = 1, e = -gamma for
    GAMMA), then random groups of widely varying scale."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n).astype(np.float32)
    mag = np.exp(rng.uniform(-20, 5, n // group_size)).astype(np.float32)
    g *= np.repeat(mag, group_size)
    e *= np.repeat(mag, group_size) * np.float32(0.01)
    G = group_size
    g[:G] = 0.0
    e[:G] = 0.0
    g[G:2 * G] = -0.0
    e[G:2 * G] = -0.0
    sgn = np.where(rng.random(G) < 0.5, -1.0, 1.0).astype(np.float32)
    tiny = np.float32(1.0) if denormals else np.float32(1e6)
    g[2 * G:3 * G] = sgn * np.float32(1e-40) * tiny
    e[2 * G:3 * G] = -sgn * np.float32(3e-41) * tiny
    g[3 * G:4 * G] = 1.0
    e[3 * G:4 * G] = -GAMMA
    return g, e


GAMMA = np.float32(0.37)


def flash_inputs(B: int, Hkv: int, groups: int, S: int, hd: int, dtype,
                 seed: int, q_scale: float = 1.0):
    """numpy (q, k, v) of attention in JAX's layout, q pre-scaled by
    hd**-0.5 * q_scale.  The keys of the last quarter of the positions are
    8 times larger, so the largest raw score of most earlier rows sits at a
    masked (future) position; q_scale = 100 drives the scores far past a
    softcap of 50.  dtype is "float32" or "bfloat16" (rounded by torch)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * groups, S, hd)) * (hd ** -0.5 * q_scale)
    k = rng.standard_normal((B, Hkv, S, hd))
    v = rng.standard_normal((B, Hkv, S, hd))
    k[:, :, S - S // 4:] *= 8.0
    dt = getattr(torch, dtype)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(dt)
                 for x in (q, k, v))


def ulp_diff(a, b) -> np.ndarray:
    """Distance in units in the last place between f32 arrays of one sign
    (both >= 0: group scales)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def check_ef_outputs(ref, got, group_size: int, max_ulp: int = 2,
                     fma_ref: bool = False):
    """ref/got = (words, scales, c, e_new) numpy.  Words exact, scales
    within max_ulp.  c and e_new are exact where the group scales agree;
    elsewhere c is within max_ulp ulps of the scale, and e_new = acc - c
    within that plus one rounding of e_new itself (a scale ulp is smaller
    than an ulp of e_new wherever |acc| exceeds the scale).  fma_ref: the
    reference contracted gamma*g + e into one FMA, so its acc, and hence
    e_new, may sit one ulp of acc away everywhere."""
    w0, s0, c0, e0 = ref
    w1, s1, c1, e1 = got
    np.testing.assert_array_equal(w0.view(np.uint32), w1.view(np.uint32))
    du = ulp_diff(s0, s1)
    assert du.max() <= max_ulp, f"scale ulp {du.max()}"
    same = np.repeat(du == 0, group_size)
    tol = np.repeat(np.spacing(np.maximum(s0, s1)) * max_ulp, group_size)
    for a, b, extra in ((c0, c1, 0.0), (e0, e1, None)):
        if a is None:
            continue
        if extra is None:
            extra = np.spacing(np.maximum(np.abs(a), np.abs(b)))
            if fma_ref:
                extra = extra + np.spacing(np.abs(c0) + np.abs(e0))
        if not (fma_ref and a is e0):
            np.testing.assert_array_equal(a[same].view(np.int32),
                                          b[same].view(np.int32))
        assert np.all(np.abs(a - b) <= tol + extra)


def topk_inputs(n: int, block_size: int, k: int, seed: int,
                denormals: bool = True):
    """(g, e) f32 of length n for the block top-K wire, with adversarial
    blocks first (acc = gamma*g + e): all zeros; -0.0 everywhere; tiny
    values (denormal acc, or with denormals=False small normals);
    k + 1 equal maxima of mixed sign over small values; exactly k nonzeros;
    every |acc| equal; then random blocks of widely varying scale."""
    rng = np.random.default_rng(seed)
    B = block_size
    g = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n).astype(np.float32)
    mag = np.exp(rng.uniform(-20, 5, n // B)).astype(np.float32)
    g *= np.repeat(mag, B)
    e *= np.repeat(mag, B) * np.float32(0.01)
    blk = [slice(i * B, (i + 1) * B) for i in range(6)]
    g[blk[0]] = 0.0
    e[blk[0]] = 0.0
    g[blk[1]] = -0.0
    e[blk[1]] = -0.0
    # tiny block: with denormals=False every |acc| and every rounding
    # error of e' = acc - c stays normal (|acc| >= 2**-103), since XLA:CPU
    # flushes denormal results too
    tiny = np.float32(1.0) if denormals else np.float32(1e10)
    sgn = np.where(rng.random(B) < 0.5, -1.0, 1.0).astype(np.float32)
    g[blk[2]] = sgn * rng.uniform(1, 2, B).astype(np.float32) * 1e-40 * tiny
    e[blk[2]] = sgn * rng.uniform(1, 3, B).astype(np.float32) * 1e-41 * tiny
    ties = rng.choice(B, k + 1, replace=False)
    g[blk[3]] *= np.float32(1e-3) / np.abs(g[blk[3]]).max()
    e[blk[3]] = 0.0
    g[blk[3].start + ties] = np.where(np.arange(k + 1) % 2, -2.0, 2.0)
    g[blk[4]] = 0.0
    e[blk[4]] = 0.0
    g[blk[4].start + rng.choice(B, k, replace=False)] = \
        rng.standard_normal(k).astype(np.float32)
    g[blk[5]] = np.where(rng.random(B) < 0.5, -1.0, 1.0)
    e[blk[5]] = 0.0
    return g, e


KB = 16            # global top-K's k: ceil(topk_k / nd) = ceil(64 / 4)


def topk_chunks(nd, B, seed, denormals=True):
    """(nd * B,) f32 of global top-K chunks of widely varying scale, with
    adversarial chunks first: a tie at the KB-th largest |x| between two
    far-apart positions; fewer than KB nonzeros with a -0.0 and a denormal
    (with denormals=False a small normal: XLA:CPU flushes denormals,
    ROADMAP C6); all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(nd * B).astype(np.float32)
    x *= np.repeat(np.exp(rng.uniform(-10, 10, nd)), B).astype(np.float32)
    c0 = x[:B]
    c0 *= np.float32(1e-3) / np.abs(c0).max()
    c0[300:300 + KB - 1] = 7.0
    c0[[1, B - 2]] = [3.0, -3.0]          # only position 1 can be kept
    if nd > 1:
        c1 = x[B:2 * B]
        c1[:] = 0.0
        c1[7:7 + 3 * (KB // 2):3] = -1.25
        c1[5] = 1e-40 if denormals else 1e-30
        c1[4] = -0.0
    if nd > 2:
        x[2 * B:3 * B] = 0.0
    return x


def topk_rows(B: int, seed: int, denormals: bool = False) -> np.ndarray:
    """(16 * B,) f32, 16 blocks of B for `block_topk`: the adversarial row
    families of tests/test_topk_select.py (ties, all equal, tiny,
    zero-riddled, all zero), a block of -0.0, one of mixed signed zeros
    with a few ties, ties around zero, then random blocks of widely varying
    scale.  The tiny block is denormal with denormals=True; otherwise every
    |x| is >= 2**-126 or zero (XLA:CPU flushes denormals, ROADMAP C6)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, B)).astype(np.float32)
    tiny = np.float32(2.0 ** (-140 if denormals else -126))
    x[0] = np.round(x[0] * 3.0) / 3.0                 # ties
    x[1] = np.where(x[1] >= 0, 1.0, -1.0)             # all equal
    x[2] = np.where(x[2] >= 0, 1.0, -1.0) * rng.uniform(1, 4, B) * tiny
    x[3, ::2] = 0.0                                   # zero-riddled
    x[4] = 0.0
    x[5] = -0.0
    x[6] = np.where(rng.random(B) < 0.5, -0.0, 0.0)
    x[6, 3::7] = np.round(x[6, 3::7])                 # few ties among zeros
    x[7] = np.round(x[7] * 2.0) / 2.0                 # ties around zero
    x[8:] *= np.exp(rng.uniform(-20, 20, (8, 1))).astype(np.float32)
    return x.reshape(-1)


def topk_payload(N: int, nb: int, k: int, block_size: int, seed: int):
    """Random block top-K payloads for N senders: distinct in-block indices
    (int64), values in [-1, 1] with some -0.0 and +0.0, scales with a few
    all-zero-block 1.0s, and a mask with a straggler."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((N, nb, block_size)), axis=-1)[..., :k]
    val = rng.uniform(-1, 1, (N, nb, k)).astype(np.float32)
    val[0, 0] = -0.0
    val[1, 1, :k // 2] = 0.0
    scales = np.exp(rng.uniform(-10, 2, (N, nb))).astype(np.float32)
    scales[:, 2] = 1.0
    mask = np.ones(N, np.float32)
    mask[1 % N] = 0.0
    return idx, val, scales, mask


# The slice end to end against JAX's real train step
# (tests/test_torch_train.py, tests/test_torch_coco.py,
# tests/test_torch_families.py): the f32 smoke config of an arch (gemma2-2b
# unless the run's keywords name another under "arch"), g = G, N coding
# ranks, STEPS steps at the constant learning rate LR.  With the
# embeddings input JAX's batch is dumped as emb{t} (bf16 bits, uint16) and
# targets{t} in place of tokens{t}.
SRC = str(Path(__file__).resolve().parents[1] / "src")
STEPS, N, G, LR = 3, 4, 32, 5e-3

JAX_RUN = textwrap.dedent(f"""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, math, warnings
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.configs import REGISTRY
    from repro.configs.common import ShapeCfg
    from repro.core.cocoef import flatten_local
    from repro.launch.train import (TrainRun, build_train_setup,
                                    make_batch_for_step, setup_encode_weights)
    warnings.simplefilter("ignore")
    kw = json.loads(sys.argv[2]) if len(sys.argv) > 2 else {{}}
    spec = REGISTRY[kw.pop("arch", "gemma2-2b")]
    spec = dataclasses.replace(
        spec, smoke=dataclasses.replace(spec.smoke, dtype="float32"),
        coding=dataclasses.replace(spec.coding, group_size={G}))
    mesh = make_mesh((4, 1), ("data", "model"))
    shape = ShapeCfg("train", 32, 8)
    if "k_budgets" in kw:
        kw["k_budgets"] = tuple(kw["k_budgets"])
    if "wire_dtype" in kw:
        spec = dataclasses.replace(spec, coding=dataclasses.replace(
            spec.coding, wire_dtype=kw.pop("wire_dtype")))
    mesh_stage2 = kw.pop("mesh_stage2", False)
    pad = (math.lcm({G}, spec.coding.block_size)
           if kw.get("compressor") == "block_topk" else {G})
    setup = build_train_setup(spec, mesh, shape,
                              TrainRun(base_lr={LR}, backend="pallas", **kw),
                              smoke=True)
    key = jax.random.PRNGKey(0)
    params, e, opt = setup.init_state(key)
    flat = lambda leaves: np.asarray(flatten_local(leaves, 4, pad)[0])
    out = {{"flat_pad": setup.flat_pad,
            "W": np.asarray(setup_encode_weights(setup))}}
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        # bf16 leaves (param_dtype) as their exact f32 values
        out["p0/" + "/".join(k.key for k in p)] = np.asarray(
            v.astype(jnp.float32))
    out["theta0"] = flat(jax.tree.leaves(params))
    model = setup.model
    grads = jax.jit(lambda p, b: jax.vmap(
        lambda bb: jax.grad(lambda q: model.loss(q, bb)[0])(p))(b))
    step = jax.jit(setup.train_step)
    for t in range(3):
        batch = make_batch_for_step(setup, spec, shape, key, t, smoke=True)
        g = grads(params, batch)
        out[f"g{{t}}"] = np.stack([flat([l[i] for l in jax.tree.leaves(g)])
                                  for i in range(4)])
        if "targets" in batch:
            out[f"emb{{t}}"] = np.asarray(batch["inputs"]).view(np.uint16)
            out[f"targets{{t}}"] = np.asarray(batch["targets"])
        else:
            out[f"tokens{{t}}"] = np.asarray(batch["inputs"])
        out[f"weights{{t}}"] = np.asarray(batch["weights"])
        out[f"mask{{t}}"] = np.asarray(setup.straggler_process.mask(key, t))
        params, e, opt, m = step(params, e, opt, batch, jnp.int32(t), key)
        out[f"loss{{t}}"] = np.asarray(m["loss"])
        out[f"theta{{t+1}}"] = flat(jax.tree.leaves(params))
        out[f"e{{t+1}}"] = np.asarray(e.astype(jnp.float32)).reshape(4, -1)
    if mesh_stage2:
        # JAX's stage 2 alone on the mesh (cocoef_update in a shard_map
        # over the 4 devices), fed the dumped gradients, state and masks
        from jax.sharding import PartitionSpec as P
        from repro.compat import shard_map
        from repro.core.cocoef import coding_rank_index, cocoef_update
        cfg = setup.cocoef_cfg
        # the sign wire's payload too: JAX's local step in the same jit
        sign = cfg.compressor == "sign" and cfg.mode == "cocoef"

        def s2(g, e, mask):
            g, e = g.reshape(-1), e.reshape(-1)
            gh, en = cocoef_update(g, e, mask, jnp.float32({LR}), cfg)
            res = (gh.reshape(1, -1), en.reshape(1, -1))
            if sign:
                i = coding_rank_index(cfg.coding_axes)
                (w, sc), _, _ = cfg.wire_format(g.shape[0], 4) \
                    .fused_local_step(g, e, jnp.float32({LR}), mask[i],
                                      use_pallas=True, want_c=False)
                res += (w.reshape(1, -1), sc.reshape(1, -1))
            return res
        s2 = jax.jit(shard_map(s2, mesh, in_specs=(P("data"), P("data"),
                                                   P()),
                               out_specs=(P("data"),) * (4 if sign else 2),
                               check=False))
        for t in range(3):
            e_in = (np.zeros_like(out["g0"]) if t == 0
                    else out[f"e{{t}}"])
            res = s2(out[f"g{{t}}"], e_in, out[f"mask{{t}}"])
            out[f"s2_ghat{{t}}"] = np.asarray(res[0])
            out[f"s2_e{{t}}"] = np.asarray(res[1].astype(jnp.float32))
            if sign:
                out[f"s2_words{{t}}"] = np.asarray(res[2])
                out[f"s2_scales{{t}}"] = np.asarray(res[3])
    np.savez(sys.argv[1], **out)
""")


def _jax_run(tmp_path_factory, run_kw=None):
    path = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", JAX_RUN, str(path)]
                       + ([json.dumps(run_kw)] if run_kw else []), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


def _port_setup(wire_dtype="float32", device="cpu", arch="gemma2-2b",
                **run_kw):
    spec = REGISTRY[arch]
    spec = dataclasses.replace(
        spec, smoke=dataclasses.replace(spec.smoke, dtype="float32"),
        coding=dataclasses.replace(spec.coding, group_size=G,
                                   wire_dtype=wire_dtype))
    return build_train_setup(spec, ShapeCfg("train", 32, 8),
                             TrainRun(base_lr=LR, **run_kw), smoke=True,
                             n_code=N, device=device)


def jax_batch(ref, t: int):
    """JAX's dumped batch of step t in the port's form: (tokens, weights),
    or (embeddings bf16, targets, weights)."""
    w = torch.from_numpy(ref[f"weights{t}"])
    if f"emb{t}" not in ref:
        return torch.from_numpy(ref[f"tokens{t}"]).long(), w
    emb = torch.from_numpy(ref[f"emb{t}"].view(np.int16)).view(
        torch.bfloat16)
    return emb, torch.from_numpy(ref[f"targets{t}"]).long(), w


def _state_dict(ref):
    return {k[3:]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith("p0/")}


def _normal_blocks(acc: np.ndarray, e_new: np.ndarray) -> np.ndarray:
    """(N, n/B) True for the blocks where no acc and no e' is denormal:
    XLA:CPU flushes denormal operands and results to zero (ROADMAP C6),
    which can change a block's selection and its e'."""
    tiny = np.finfo(np.float32).tiny

    def denormal(x):
        return ((x != 0) & (np.abs(x) < tiny)).reshape(N, -1, 256).any(-1)
    return ~(denormal(acc) | denormal(e_new))


# Stage 2 alone on seeded inputs, the port against JAX's mesh
# `cocoef_update` (tests/test_torch_parity.py; JAX runs them all in one
# subprocess, `_torch_wire_cases.jax_mesh_cases`).  Each case: the coding
# axes of JAX's mesh (the port's grid shape), CocoEFConfig keywords, and
# the inputs.  gamma is 0.5, so gamma*g is exact and XLA's contraction of
# gamma*g + e into an FMA (ROADMAP C12) cannot change a bit.  "int" inputs
# have small integer g and quarter-integer e: every group sum is exact in
# any order, so the sign wire's scales equal JAX's bit for bit (no C3
# allowance) and every cross-rank sum is exact; "float" inputs are random
# normals of mixed scale, where the order of a sum shows.
MESH_N, MESH_GAMMA = 4 * 256 * 4, 0.5
MESH_MASK = (1.0, 0.0, 1.0, 1.0)
MESH_CASES = {
    "sign_b2_pipelined": (("data",), {"num_buckets": 2}, "int"),
    "sign_b2_serial": (("data",), {"num_buckets": 2,
                                   "bucket_schedule": "serial"}, "int"),
    "block_b2_pipelined": (("data",), {"compressor": "block_topk",
                                       "block_size": 64, "k_per_block": 4,
                                       "num_buckets": 2}, "float"),
    "block_b2_serial": (("data",), {"compressor": "block_topk",
                                    "block_size": 64, "k_per_block": 4,
                                    "num_buckets": 2,
                                    "bucket_schedule": "serial"}, "float"),
    "identity_b2": (("data",), {"compressor": "identity",
                                "num_buckets": 2}, "float"),
    "coco_sign_b2": (("data",), {"mode": "coco", "num_buckets": 2}, "int"),
    "sign_phase2_bf16": (("data",), {"phase2_dtype": "bfloat16"}, "int"),
    "sign_phase2_sign": (("data",), {"phase2_sign": True,
                                     "num_buckets": 2}, "int"),
    "block_phase2_bf16": (("data",), {"compressor": "block_topk",
                                      "block_size": 64, "k_per_block": 4,
                                      "phase2_dtype": "bfloat16"}, "float"),
    "dense": (("data",), {"mode": "dense"}, "float"),
    "grid_sign": (("pod", "data"), {}, "int"),
    "grid_block_b2": (("pod", "data"), {"compressor": "block_topk",
                                        "block_size": 64, "k_per_block": 4,
                                        "num_buckets": 2}, "float"),
    "grid_identity": (("pod", "data"), {"compressor": "identity"}, "float"),
    "grid_block_phase2_bf16": (("pod", "data"), {
        "compressor": "block_topk", "block_size": 64, "k_per_block": 4,
        "phase2_dtype": "bfloat16"}, "float"),
    "grid_dense": (("pod", "data"), {"mode": "dense"}, "float"),
}


def mesh_inputs(kind: str, seed: int = 0):
    """(g, e) (4, MESH_N) f32 of `kind` ("int" or "float")."""
    rng = np.random.default_rng(seed)
    shape = (4, MESH_N)
    if kind == "int":
        g = rng.integers(-8, 9, shape).astype(np.float32)
        e = (rng.integers(-4, 5, shape) * 0.25).astype(np.float32)
        return g, e
    mag = np.exp(rng.uniform(-6, 2, (4, MESH_N // 64)))
    g = rng.standard_normal(shape) * np.repeat(mag, 64, axis=1)
    e = rng.standard_normal(shape) * np.repeat(mag, 64, axis=1) * 0.1
    return g.astype(np.float32), e.astype(np.float32)


# Stage 2 with bf16 state (tests/test_torch_dtypes.py): the MESH_CASES
# inputs with g and e stored in bf16 (TrainRun.param_dtype gives a bf16
# gradient, TrainRun.ef_dtype a bf16 e), against JAX's mesh
# `cocoef_update` with CocoEFConfig.ef_dtype, whose flat gradient is the
# bf16 gradient widened (flatten_local).  Each case: coding axes,
# CocoEFConfig keywords (ef_dtype is added per dtype pair), input kind.
_BLOCK = {"compressor": "block_topk", "block_size": 64, "k_per_block": 4}
DTYPE_CASES = {
    "sign": (("data",), {}, "int"),
    "sign_b2_serial": (("data",), {"num_buckets": 2,
                                   "bucket_schedule": "serial"}, "int"),
    "sign_phase2_sign": (("data",), {"phase2_sign": True,
                                     "num_buckets": 2}, "int"),
    "block": (("data",), _BLOCK, "float"),
    "block_b2": (("data",), {**_BLOCK, "num_buckets": 2}, "float"),
    "block_budgets": (("data",), {**_BLOCK, "k_per_block": (4, 4, 2, 1)},
                      "float"),
    "block_values_bf16": (("data",), {**_BLOCK, "wire_dtype": "bfloat16",
                                      "phase2_dtype": "bfloat16"},
                          "float"),
    "identity": (("data",), {"compressor": "identity"}, "float"),
    "identity_bf16": (("data",), {"compressor": "identity",
                                  "wire_dtype": "bfloat16"}, "float"),
    "topk": (("data",), {"compressor": "topk"}, "float"),
    "coco_sign": (("data",), {"mode": "coco", "num_buckets": 2}, "int"),
    "coco_block_budgets": (("data",), {**_BLOCK, "mode": "coco",
                                       "k_per_block": (4, 4, 2, 1)},
                           "float"),
    "coco_identity": (("data",), {"compressor": "identity",
                                  "mode": "coco"}, "float"),
    "coco_topk": (("data",), {"compressor": "topk", "mode": "coco"},
                  "float"),
    "dense": (("data",), {"mode": "dense"}, "float"),
    "grid_sign": (("pod", "data"), {}, "int"),
    "grid_block_b2": (("pod", "data"), {**_BLOCK, "num_buckets": 2},
                      "float"),
    "grid_identity": (("pod", "data"), {"compressor": "identity"},
                      "float"),
    "grid_dense": (("pod", "data"), {"mode": "dense"}, "float"),
}
# (g dtype, e dtype): both bf16 for every case; each field alone for the
# cases that read e
DTYPE_PAIRS = {"bf16": ("bfloat16", "bfloat16"),
               "g_bf16": ("bfloat16", "float32"),
               "e_bf16": ("float32", "bfloat16")}
ALONE = ("sign", "block_budgets", "identity_bf16", "topk", "grid_sign")


def dtype_case_names():
    """'<case>/<pair>' for every case with both fields bf16, and each
    field alone for the cases in ALONE."""
    return [f"{c}/{p}" for c in DTYPE_CASES for p in DTYPE_PAIRS
            if p == "bf16" or c in ALONE]


def dtype_case(name: str):
    """(axes, CocoEFConfig keywords with ef_dtype, g (4, MESH_N) f32, e
    (4, MESH_N) f32, g dtype, e dtype) of a `dtype_case_names` name: the
    MESH_CASES inputs rounded to the stored dtypes (exact in f32)."""
    case, pair = name.split("/")
    axes, kw, kind = DTYPE_CASES[case]
    gdt, edt = DTYPE_PAIRS[pair]
    g, e = mesh_inputs(kind, seed=3)

    def stored(x, dt):
        return torch.from_numpy(x).to(getattr(torch, dt)).float().numpy()
    return (axes, {**kw, "ef_dtype": edt}, stored(g, gdt), stored(e, edt),
            gdt, edt)


# --- the sharded serve (tests/test_torch_shard_serve.py, the gloo job) -----

SHARD_ARCHS = ("gemma2-2b", "phi3-medium-14b", "musicgen-large")
SHARD_MESHES = ((2, 2), (1, 4))
SHARD_CASES = [(a, m) for a in SHARD_ARCHS for m in SHARD_MESHES]
SHARD_B, SHARD_S, SHARD_STEPS = 8, 16, 3


def shard_params(arch: str) -> dict:
    """Seeded f32 parameters of `arch`'s smoke config, name -> numpy, at
    JAX's init scales: normal / sqrt(fan_in) (`dense_init`'s in-axis
    size: d for wq, wk, wv and proj, H * hd for wo, the rows of the MLP
    and head matrices), the token table normal, the norms' scales
    1 + normal / 10 and the biases normal / 10."""
    from repro_torch.nn.transformer import param_shapes
    rng = np.random.default_rng(7)
    out = {}
    for name, shape in sorted(param_shapes(REGISTRY[arch].smoke).items()):
        x = rng.standard_normal(shape).astype(np.float32)
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "scale":
            x = 1 + x / 10
        elif leaf in ("bq", "bk", "bv", "bias"):
            x = x / 10
        elif leaf in ("wq", "wk", "wv"):
            x = x / np.float32(np.sqrt(shape[-3]))
        elif leaf == "wo":
            x = x / np.float32(np.sqrt(shape[-3] * shape[-2]))
        elif leaf != "tok":
            x = x / np.float32(np.sqrt(shape[-2]))
        out[name] = x.astype(np.float32)
    return out


def shard_inputs(arch: str):
    """(prompt (B, S), SHARD_STEPS decode feeds (B, 1)): int32 tokens, or
    f32 embeddings of scale 0.02 that each side rounds to bf16."""
    cfg = REGISTRY[arch].smoke
    rng = np.random.default_rng(8)

    def draw(n):
        if cfg.input_mode == "tokens":
            return rng.integers(0, cfg.vocab_size, (SHARD_B, n)
                                ).astype(np.int32)
        return (rng.standard_normal((SHARD_B, n, cfg.d_model)) * 0.02
                ).astype(np.float32)
    return draw(SHARD_S), [draw(1) for _ in range(SHARD_STEPS)]


def _torch_input(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if t.is_floating_point() else t


def _host_copy(tree):
    """A copy on the CPU of every tensor of a (nested) list or dict."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree.to("cpu", copy=True)


def run_sharded(arch: str, mesh=None, device="cpu") -> dict:
    """The port's serve of `arch`'s smoke config from `shard_params`:
    the prefill of `shard_inputs`' prompt, then its SHARD_STEPS decode
    steps at positions S, S + 1, ... on `mesh` (a `DeviceMesh`; None: one
    device).  Returns {"logits": the prefill's and each step's, "caches":
    the prefill's and the last step's}, on a mesh as lists of the local
    devices' blocks, on the CPU."""
    from repro_torch.launch.serve import build_serve_setup
    setup = build_serve_setup(REGISTRY[arch],
                              ShapeCfg("prefill", SHARD_S, SHARD_B),
                              smoke=True, device=device, mesh=mesh)
    setup.model.load_params({k: torch.from_numpy(v)
                             for k, v in shard_params(arch).items()})
    prompt, feeds = shard_inputs(arch)
    logits, caches = setup.prefill_step(_torch_input(prompt).to(device))
    out = {"logits": [_host_copy(logits)], "caches": [_host_copy(caches)]}
    for t, feed in enumerate(feeds):
        logits, caches = setup.decode_step(
            caches, _torch_input(feed).to(device), SHARD_S + t)
        out["logits"].append(_host_copy(logits))
    out["caches"].append(_host_copy(caches))
    return out
