"""bf16 parameters and bf16 error vectors (`TrainRun.param_dtype`,
`TrainRun.ef_dtype`, `CocoEFConfig.ef_dtype`) against the JAX package.

  - theta0 in bf16 (`Model.init_`) equals `jax.jit(init_params)` with
    param_dtype "bfloat16" (JAX draws in f32 and casts once), for gemma2
    and one arch of each other family: bit for bit.
  - The plain versions of the fused local steps on bf16 e (and bf16 g)
    against JAX's Pallas kernels in interpret mode, e' cast to bf16 as
    JAX's `cocoef_update` does: every output bit for bit.  The inputs keep
    gamma*g exact (gamma 0.5), so XLA:CPU's contraction of gamma*g + e
    into an FMA (ROADMAP C4/C12) cannot change a bit, and on the sign wire
    every group sum is exact in any order (no C3 allowance).  The block
    top-K budgets use JAX's budget branch (pack, zero past k_i, unpack).
  - `sign_pack` / `topk_pack` with gamma (acc = gamma * g rounded once in
    f32, from f32 or bf16 g) against JAX's `gamma * g` then the Pallas
    pack: block top-K bit for bit at gamma 0.37; the sign wire's words bit
    for bit and its scales within 6 ulp (the group sum order, C3), and bit
    for bit against the port's own f32 product then pack.
  - Stage 2 alone on seeded inputs (`_torch_cases.DTYPE_CASES`: every
    wire and mode, budgets, buckets, phase 2, 1-D and 2 x 2 grids) with g
    and e stored in bf16, and each alone, against JAX's mesh
    `cocoef_update` with ef_dtype (one subprocess): ghat and e' bit for
    bit, on one device and on the gloo grid (4 processes).
  - The 3-step mesh run (JAX's `build_train_setup` + `train_step` with
    TrainRun(param_dtype=..., ef_dtype=...)): theta0 bit for bit; stage 2
    on JAX's injected gradients against JAX's mesh stage 2 (block top-K:
    every index set, value, scale and e' bit for bit except where XLA's
    FMA (C12) moved acc across a bf16 rounding boundary of e' or a
    selection tie: at most 1e-3 of e' off, each by at most one bf16 ulp of
    acc plus an f32 ulp, or by a swapped pick; the sign wire, against
    JAX's payload: scales within 6 ulp (C3), words equal except at the
    coordinates where C12's FMA changes acc's sign (acc 0 one way, not the
    other; at most 1e-3 of them), a straggler's e' bit for
    bit, the others' within one bf16 ulp of |acc| + scale, an f32 ulp of
    acc and 6 scale ulps (2 * scale more at a flipped sign), ghat within
    6 scale ulps and 2 * scale per flipped rank plus N ulps of the
    summed scales); the whole step: loss within 1e-4 relative,
    theta and e' within the stage-2 bounds grown by one bf16 ulp of theta
    a step (stage 1 differs by bf16 rounding of the gradients).
  - `apply_update` on a bf16 theta with weight decay: JAX's update of the
    widened theta cast to bf16, bit for bit (sgd, momentum; adam within
    one bf16 ulp: pow and sqrt), the norms within 1e-6 relative.
  - A bf16 checkpoint (params and e) written by the port restores in JAX
    and one JAX writes restores in the port, every bit.
  - A kernel wrapper refuses a dtype without an instance (f16).
Every torch computation runs on one thread (`_torch_cases.one_thread`).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (LR, MESH_GAMMA, MESH_MASK, N, SRC, STEPS,
                          _jax_run, _port_setup, _state_dict, dtype_case,
                          dtype_case_names, one_thread)
from _torch_gloo import TRAIN_STEPS, run_gloo, train_spec
from repro.checkpoint import checkpoint as jck
from repro.configs import REGISTRY as JREG
from repro.kernels import ref as jref
from repro.kernels import sign_pack as jsp
from repro.kernels import topk_pack as jtp
from repro.nn.models import Model as JModel
from repro.optim import optimizers as joptim
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.convert import params_from_jax
from repro_torch.core.cocoef import CocoEFConfig, cocoef_update
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import TrainRun, _payload_buffers, \
    build_train_setup
from repro_torch.nn.models import Model
from repro_torch.optim import optimizers as optim

BF16 = torch.bfloat16
ARCHS = ("gemma2-2b", "olmoe-1b-7b", "deepseek-v2-lite-16b", "zamba2-2.7b",
         "xlstm-1.3b", "musicgen-large")


def _bits(x) -> np.ndarray:
    """f32 bit patterns (bf16 widened exactly) of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _equal(a, b, msg=""):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=msg)


def _jbf16(x: np.ndarray):
    return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_theta0_bf16_equals_jax(arch):
    jcfg = dataclasses.replace(JREG[arch].smoke, param_dtype="bfloat16")
    want = params_from_jax(jax.tree.map(np.asarray, jax.jit(
        JModel(jcfg).init)(jax.random.PRNGKey(0))))
    cfg = dataclasses.replace(REGISTRY[arch].smoke, param_dtype="bfloat16")
    with one_thread():
        m = Model(cfg, chunk_ranks=4, group_size=32, device="cpu")
        m.init_(0)
    assert m.theta.dtype == BF16 and m.grad.dtype == BF16
    got = m.params()
    assert set(got) == set(want)
    for k, v in got.items():
        assert want[k].dtype == BF16, k
        _equal(v, want[k], k)


def _sign_inputs(n, seed):
    """g integers, e sixty-fourths: every group sum of acc = 0.5 g + e is
    exact, and e' = acc - c has more bits than bf16 keeps."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-100, 101, n).astype(np.float32)
    e = (rng.integers(-64, 65, n) / 64.0).astype(np.float32)
    g[:64] = -0.0
    e[:64] = -0.0
    return g, e


@pytest.mark.parametrize("gdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("mask", [1.0, 0.0])
def test_ef_sign_fused_bf16_e_equals_pallas(gdt, mask):
    G, n = 32, 32 * 8 * 8
    g, e = _sign_inputs(n, 1)
    jg = _jbf16(g) if gdt == "bfloat16" else jnp.asarray(g)
    w, s, c, en = jsp.ef_sign_fused(jg, _jbf16(e), jnp.float32(0.5),
                                    jnp.float32(mask), G, want_c=True,
                                    interpret=True)
    en = en.astype(jnp.bfloat16)
    tg = torch.from_numpy(g).to(getattr(torch, gdt))
    te = torch.from_numpy(e).to(BF16)
    with one_thread():
        got = ops.ef_sign_fused(tg, te, 0.5, mask, G, want_c=True)
    assert got[3].dtype == BF16
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  np.asarray(w).view(np.int32))
    _equal(got[1], np.asarray(s))
    _equal(got[2], np.asarray(c))
    _equal(got[3], np.asarray(en.astype(jnp.float32)))
    if mask == 0.0:
        _equal(got[3], te)                  # a straggler keeps e's bits


def _topk_inputs(n, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n)
         * np.exp(rng.uniform(-6, 3, n))).astype(np.float32)
    e = (rng.standard_normal(n) * 0.1).astype(np.float32)
    g[:64], e[:64] = 0.0, 0.0
    # -0.0 + 0.0 = +0.0: a kept -0.0 is ROADMAP C7 (the Pallas kernel's
    # masked sums make it +0.0), held in tests/test_torch_sparse.py
    g[64:128], e[64:128] = -0.0, 0.0
    g[128:192] = 2.0                        # ties
    e[128:192] = 0.0
    return g, e


@pytest.mark.parametrize("gdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("k_send", [None, 2])
@pytest.mark.parametrize("vdt", ["float32", "bfloat16"])
def test_ef_topk_fused_bf16_e_equals_pallas(gdt, k_send, vdt):
    B, k, n = 64, 4, 64 * 8 * 4
    g, e = _topk_inputs(n, 2)
    jg = _jbf16(g) if gdt == "bfloat16" else jnp.asarray(g)
    je = _jbf16(e)
    gam, m = jnp.float32(0.5), jnp.float32(1.0)
    if k_send is None:
        idx, val, sc, c, en = jtp.ef_topk_fused(jg, je, gam, m, k, B,
                                                want_c=True, value_dtype=vdt,
                                                interpret=True)
    else:                                   # JAX's budget branch
        acc = jref.mul_add(gam, jg, je)
        idx, val, sc = jtp.topk_pack(acc, k, B, interpret=True)
        val = val.astype(jnp.dtype(vdt)).astype(jnp.float32)
        val = val.at[:, k_send:].set(0.0)
        c = jref.topk_unpack_ref(idx, val, sc, B)
        en = jnp.where(m > 0, acc - c, je.astype(jnp.float32))
    en = en.astype(jnp.bfloat16)
    tg = torch.from_numpy(g).to(getattr(torch, gdt))
    te = torch.from_numpy(e).to(BF16)
    with one_thread():
        gi, gv, gs, gc, ge = ops.ef_topk_fused(tg, te, 0.5, 1.0, k, B, vdt,
                                               want_c=True, k_send=k_send)
    assert ge.dtype == BF16
    np.testing.assert_array_equal(gi.to(torch.int64).numpy(),
                                  np.asarray(idx).astype(np.int64))
    _equal(gv, np.asarray(jnp.asarray(val).astype(jnp.float32)))
    _equal(gs, np.asarray(sc))
    _equal(gc, np.asarray(c))
    _equal(ge, np.asarray(en.astype(jnp.float32)))


@pytest.mark.parametrize("gdt", ["bfloat16", "float32"])
def test_sign_pack_with_gamma(gdt):
    G, n = 32, 32 * 8 * 8
    rng = np.random.default_rng(3)
    g = (rng.standard_normal(n) * np.exp(rng.uniform(-5, 5, n))).astype(
        np.float32)
    tg = torch.from_numpy(g).to(getattr(torch, gdt))
    gw = np.asarray(tg.float())
    gam = np.float32(0.37)
    w, s = jsp.sign_pack(jnp.float32(gam) * jnp.asarray(gw), G,
                         interpret=True)
    with one_thread():
        pw, ps = ops.sign_pack(tg, G, gamma=gam)
        own = ref.sign_pack_ref((torch.tensor(gam) * tg.float()), G)
    np.testing.assert_array_equal(pw.numpy().view(np.int32),
                                  np.asarray(w).view(np.int32))
    du = np.abs(_bits(ps).astype(np.int64) - _bits(np.asarray(s)))
    assert du.max() <= 6                                   # C3
    _equal(ps, own[1])
    np.testing.assert_array_equal(pw.numpy(), own[0].numpy())


@pytest.mark.parametrize("gdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("k_send", [None, 1])
def test_topk_pack_with_gamma(gdt, k_send):
    B, k, n = 64, 4, 64 * 8 * 4
    g, _ = _topk_inputs(n, 4)
    g[64:128] = 0.0                         # no kept -0.0 (C7)
    tg = torch.from_numpy(g).to(getattr(torch, gdt))
    gam = np.float32(0.37)
    idx, val, sc = jtp.topk_pack(jnp.float32(gam) * jnp.asarray(
        np.asarray(tg.float())), k, B, interpret=True)
    if k_send is not None:
        val = val.at[:, k_send:].set(0.0)
    with one_thread():
        pi, pv, ps = ops.topk_pack(tg, k, B, k_send=k_send, gamma=gam)
    np.testing.assert_array_equal(pi.to(torch.int64).numpy(),
                                  np.asarray(idx).astype(np.int64))
    _equal(pv, np.asarray(val))
    _equal(ps, np.asarray(sc))


def test_unsupported_dtype_raises():
    x = torch.zeros(1024, dtype=torch.float16)
    f = torch.zeros(1024)
    with pytest.raises(TypeError):
        ops.ef_sign_fused(x, f, 0.5, 1.0, 32)
    with pytest.raises(TypeError):
        ops.ef_topk_fused(f, x, 0.5, 1.0, 4, 64)
    with pytest.raises(TypeError):
        ops.sign_pack(x, 32, gamma=0.5)
    with pytest.raises(TypeError):
        ops.topk_pack(x, 4, 64)
    with pytest.raises(ValueError):
        TrainRun(ef_dtype="float16")
    with pytest.raises(ValueError):
        TrainRun(param_dtype="float16")


# --- stage 2 alone: DTYPE_CASES against JAX's mesh ------------------------

MESH_RUN = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import warnings
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, sys.argv[2])
    from _torch_cases import MESH_GAMMA, MESH_MASK, dtype_case
    from repro.compat import make_mesh, shard_map
    from repro.core.cocoef import CocoEFConfig, cocoef_update
    warnings.simplefilter("ignore")
    out = {}
    for name in sys.argv[3].split(","):
        axes, kw, g, e, gdt, edt = dtype_case(name)
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
        # the flat gradient is f32 (flatten_local widens a bf16 one); e
        # is stored in ef_dtype
        gh, en = f(g, jnp.asarray(e).astype(jnp.dtype(edt)),
                   np.asarray(MESH_MASK, np.float32))
        out[name + "/ghat"] = np.asarray(gh)
        out[name + "/e"] = np.asarray(en.astype(jnp.float32))
        out[name + "/edt"] = np.asarray(str(en.dtype))
    np.savez(sys.argv[1], **out)
""")

NAMES = dtype_case_names()


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dtypes") / "mesh.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", MESH_RUN, str(path),
                        str(Path(__file__).parent), ",".join(NAMES)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return run_gloo("dtypes", tmp_path_factory.mktemp("gloo_dtypes"),
                    timeout=600)


def _one_device(name):
    axes, kw, g, e, gdt, edt = dtype_case(name)
    cfg = CocoEFConfig(group_size=32, **kw)
    tg = torch.from_numpy(g).to(getattr(torch, gdt))
    te = torch.from_numpy(e).to(getattr(torch, edt))
    payload = _payload_buffers(cfg, 4, tg.shape[1], "cpu")
    with one_thread():
        ghat = cocoef_update(lambda i: tg[i], te, torch.tensor(MESH_MASK),
                             MESH_GAMMA, cfg, payload)
    return ghat, te, tg, torch.from_numpy(g).to(getattr(torch, gdt))


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if not n.startswith("grid")])
def test_one_device_stage2_matches_jax_mesh(jax_mesh, name):
    ghat, e, g_after, g_before = _one_device(name)
    assert ghat.dtype == torch.float32
    _equal(g_after, g_before)               # the gradient is not written
    for i in range(4):
        _equal(ghat, jax_mesh[name + "/ghat"][i])
    _, kw, _, _, _, edt = dtype_case(name)
    assert e.dtype == getattr(torch, edt)
    if kw.get("mode", "cocoef") == "cocoef":
        assert str(jax_mesh[name + "/edt"]) == edt
    _equal(e, jax_mesh[name + "/e"])


@pytest.mark.parametrize("name", NAMES)
def test_gloo_stage2_matches_jax_mesh(gloo, jax_mesh, name):
    """The group form (one gloo process a coding rank) on the 1-D and the
    2 x 2 grid: each rank's ghat and e' row bit for bit."""
    for r, rank in enumerate(gloo):
        ghat, e = rank[f"mesh/{name}"]
        _equal(ghat, jax_mesh[name + "/ghat"][r])
        _equal(e, jax_mesh[name + "/e"][r])


@pytest.mark.parametrize("comp", ["sign", "block_topk"])
def test_gloo_train_equals_one_device(gloo, comp):
    """3 steps with bf16 theta and e on the gloo grid equal the one-device
    setup's, theta and each rank's e row bit for bit."""
    with one_thread():
        s = build_train_setup(
            train_spec(), ShapeCfg("train", 32, 8),
            TrainRun(base_lr=5e-3, compressor=comp, param_dtype="bfloat16",
                     ef_dtype="bfloat16"), smoke=True, n_code=4,
            device="cpu")
        e = s.init_state()
        assert s.model.theta.dtype == BF16 and e.dtype == BF16
        assert s.ghat is not None and s.ghat.dtype == torch.float32
        for t in range(TRAIN_STEPS):
            m = s.train_step(s.model, e, s.make_batch(t), t)
    for r, rank in enumerate(gloo):
        _equal(rank[f"{comp}/theta"], s.model.theta)
        _equal(rank[f"{comp}/e"], e[r])
    assert abs(np.mean([rk[f"{comp}/loss{TRAIN_STEPS - 1}"] for rk in gloo])
               - m["loss"].item()) <= 1e-6 * abs(m["loss"].item())


# --- the 3-step mesh run ----------------------------------------------------

RUNS = {"sign": {"param_dtype": "bfloat16", "ef_dtype": "bfloat16"},
        "block": {"param_dtype": "bfloat16", "ef_dtype": "bfloat16",
                  "compressor": "block_topk"},
        "block_ef_alone": {"ef_dtype": "bfloat16",
                           "compressor": "block_topk"},
        "sign_param_alone": {"param_dtype": "bfloat16"}}
DUMPS = {}


@pytest.fixture(scope="module", params=list(RUNS))
def run(request, tmp_path_factory):
    name = request.param
    if name not in DUMPS:
        DUMPS[name] = _jax_run(tmp_path_factory,
                               {**RUNS[name], "mesh_stage2": True})
    return name, RUNS[name], DUMPS[name]


def _bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp at |x| (f32 array): 2^(exponent - 7)."""
    ax = np.maximum(np.abs(np.asarray(x, np.float32)),
                    np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(ax)) - 7).astype(np.float32)


def test_setup_and_theta0(run):
    name, kw, ref_ = run
    s = _port_setup(**kw)
    pdt = getattr(torch, kw.get("param_dtype", "float32"))
    assert s.model.theta.dtype == pdt
    assert s.init_state().dtype == getattr(torch, kw.get("ef_dtype",
                                                         "float32"))
    s.model.load_params(_state_dict(ref_))
    _equal(s.model.theta, ref_["theta0"])
    with one_thread():
        s.init_state()                       # JAX's key: PRNGKey(0)
    _equal(s.model.theta, ref_["theta0"])


def _bits_of(words: np.ndarray) -> np.ndarray:
    """(N, n/32) u32 sign words -> (N, n) 0/1, bit j of word w at 32w+j."""
    w = words.astype(np.uint64)[..., None] >> np.arange(32, dtype=np.uint64)
    return (w & 1).astype(np.int8).reshape(words.shape[0], -1)


def _sign_stage2(ref_, t, payload, e, ghat):
    """The sign wire against JAX's mesh stage 2 (JAX's payload from its
    local step in the same jit): scales within 6 ulp (the group sum's
    order, C3); words equal except where C12 flips a sign: XLA contracts
    gamma*g + e into an FMA, so where f32(gamma*g) + e is exactly 0 and
    the unrounded sum is not (or the other way round), the signs differ;
    those coordinates are found from the inputs, and at most 1e-3 of the
    signs may flip.  e' of a straggler bit for bit; the others' within one
    bf16 ulp of |acc| + scale, an f32 ulp of acc and 6 scale ulps, and
    2 * scale more at a flipped sign; ghat (f32 phase 2: the sum over
    ranks of mask_i * scale_i * sign_i) within 6 scale ulps and 2 * scale
    per rank whose sign flipped, plus N f32 ulps of the sum of the scales
    (the order of the sum over ranks)."""
    G = payload[0].shape[1] * 32 // payload[1].shape[1]
    ps, js = payload[1].numpy(), ref_[f"s2_scales{t}"]
    assert np.all(np.abs(ps - js) <= 6 * np.spacing(js)), "scales"
    pb = _bits_of(payload[0].view(torch.int32).numpy().view(np.uint32))
    jb = _bits_of(ref_[f"s2_words{t}"].view(np.uint32))
    g, e0 = ref_[f"g{t}"], (ref_[f"e{t}"] if t else 0.0)
    rounded = np.float32(LR) * g + np.float32(e0)     # two roundings
    fused = (np.float64(np.float32(LR)) * g.astype(np.float64)
             + np.float64(e0)).astype(np.float32)     # one, as an FMA
    c12 = (rounded >= 0) != (fused >= 0)
    flip = pb != jb
    assert not np.any(flip & ~c12), "a sign flipped that C12 cannot flip"
    assert np.mean(flip) <= 1e-3, np.mean(flip)
    mask = ref_[f"mask{t}"]
    s = np.repeat(js, G, axis=1)
    acc = np.abs(rounded)
    tol_e = (_bf16_ulp(acc + s) + np.spacing(acc) + 6 * np.spacing(s)
             + 2 * s * flip)
    got, want = e.float().numpy(), ref_[f"s2_e{t}"]
    for i in range(N):
        if mask[i] > 0:
            assert np.all(np.abs(got[i] - want[i]) <= tol_e[i]), i
        else:
            _equal(got[i], want[i])
    m = (mask > 0)[:, None]
    tol_g = (6 * np.spacing(s) * m).sum(0) + (2 * s * flip * m).sum(0) \
        + N * np.spacing((s * m).sum(0))
    assert np.all(np.abs(ghat.numpy() - ref_[f"s2_ghat{t}"][0]) <= tol_g)


def test_stage2_on_jax_gradients(run):
    """JAX's stage-1 gradients (bf16 when theta is) and state into the
    port's stage 2, against JAX's mesh stage 2 on the same inputs."""
    name, kw, ref_ = run
    s = _port_setup(**kw)
    cfg, n = s.cocoef_cfg, s.flat_pad
    gdt = getattr(torch, kw.get("param_dtype", "float32"))
    edt = getattr(torch, kw.get("ef_dtype", "float32"))
    for t in range(STEPS):
        g = torch.from_numpy(ref_[f"g{t}"]).to(gdt)
        _equal(g, ref_[f"g{t}"])              # bf16 gradients, widened
        e = (torch.zeros((N, n), dtype=edt) if t == 0
             else torch.from_numpy(ref_[f"e{t}"]).to(edt))
        payload = tuple(torch.zeros_like(p) for p in s.payload)
        with one_thread():
            ghat = cocoef_update(lambda i: g[i], e,
                                 torch.from_numpy(ref_[f"mask{t}"]), LR,
                                 cfg, payload)
        if kw.get("compressor") != "block_topk":
            _sign_stage2(ref_, t, payload, e, ghat)
            continue
        # C12 moves acc by an f32 ulp: near a rounding boundary of e' or a
        # tie of the selection; a swapped pick moves e' by the kept values,
        # bounded by the block scale
        acc = np.abs(np.float32(LR) * ref_[f"g{t}"]) + np.abs(
            ref_[f"e{t}"] if t else 0.0)
        tol_e = _bf16_ulp(acc) + np.spacing(acc.astype(np.float32))
        tol_g = payload[2].abs().max().item() * 2
        de = np.abs(e.float().numpy() - ref_[f"s2_e{t}"])
        assert np.mean(de > 0) <= 1e-3, np.mean(de > 0)
        assert np.all((de <= tol_e) | (de <= tol_g))
        assert np.abs(ghat.numpy() - ref_[f"s2_ghat{t}"][0]).max() <= tol_g


def test_end_to_end_matches_jax(run):
    """The port's whole step for 3 steps from JAX's theta0, batches and
    masks."""
    name, kw, ref_ = run
    s = _port_setup(**kw)
    s.model.load_params(_state_dict(ref_))
    e = torch.zeros((N, s.flat_pad),
                    dtype=getattr(torch, kw.get("ef_dtype", "float32")))
    bound = 0.0
    for t in range(STEPS):
        batch = (torch.from_numpy(ref_[f"tokens{t}"]).long(),
                 torch.from_numpy(ref_[f"weights{t}"]))
        with one_thread():
            m = s.train_step(s.model, e, batch, t,
                             masks=torch.from_numpy(ref_[f"mask{t}"]))
        np.testing.assert_allclose(m["loss"].item(), ref_[f"loss{t}"],
                                   rtol=1e-4)
        want = ref_[f"theta{t + 1}"]
        scale = (s.payload[2] if kw.get("compressor") == "block_topk"
                 else s.payload[1]).abs().max().item()
        bound += 2 * N * scale + float(_bf16_ulp(want).max())
        d = np.abs(s.model.theta.float().numpy() - want)
        assert d.max() <= bound
        assert np.mean(d > 0) < 0.01
        assert np.abs(e.float().numpy() - ref_[f"e{t + 1}"]).max() <= bound


# --- the optimizer and checkpoints ----------------------------------------

@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_apply_update_bf16_theta(kind):
    rng = np.random.default_rng(0)
    n = 4096
    p0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(BF16)
    gh = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    jcfg = joptim.OptimizerConfig(kind=kind, weight_decay=0.01)
    pcfg = optim.OptimizerConfig(kind=kind, weight_decay=0.01)
    jstate = joptim.init_opt_state(jcfg, n)
    pstate = optim.init_opt_state(pcfg, n, device="cpu")
    jp = jnp.asarray(p0.float().numpy()).astype(jnp.bfloat16)
    pp = p0.clone()
    for step in range(3):
        gamma = np.float32(1e-2)
        new, jstate, norms = joptim.apply_update(
            jcfg, jp.astype(jnp.float32), jnp.asarray(gh), jstate,
            jnp.int32(step), jnp.float32(gamma), want_norms=True)
        jp = new.astype(jnp.bfloat16)
        with one_thread():
            _, _, pn = optim.apply_update(pcfg, pp, torch.from_numpy(gh),
                                          pstate, step, gamma,
                                          want_norms=True)
        assert pp.dtype == BF16
        want = np.asarray(jp.astype(jnp.float32))
        if kind == "adam":
            assert np.all(np.abs(pp.float().numpy() - want)
                          <= _bf16_ulp(want))
        else:
            _equal(pp, want)
        for k in ("update_norm_sq", "param_norm_sq"):
            np.testing.assert_allclose(pn[k].item(), float(norms[k]),
                                       rtol=1e-6)
        jp = jnp.asarray(pp.float().numpy()).astype(jnp.bfloat16)


def test_checkpoint_bf16_round_trips_jax(tmp_path):
    """The port's bf16 params and e (after a step) restore in JAX bit for
    bit, and a JAX-written bf16 checkpoint restores in the port."""
    with one_thread():
        s = _port_setup(param_dtype="bfloat16", ef_dtype="bfloat16")
        e = s.init_state()
        s.train_step(s.model, e, s.make_batch(0), 0)
    state = {"params": s.model.params(), "e": e.view(N, 1, -1)}
    ck.save_checkpoint(tmp_path / "port", 1, state)
    templates = {"params": jax.tree.map(
        lambda t: np.zeros(t.shape, jnp.bfloat16),
        {k: v for k, v in state["params"].items()}),
        "e": np.zeros((N, 1, s.flat_pad), jnp.bfloat16)}
    step, got = jck.restore_checkpoint(tmp_path / "port", templates)
    assert step == 1
    for k, v in state["params"].items():
        assert got["params"][k].dtype == jnp.bfloat16
        _equal(v, np.asarray(got["params"][k]).astype(np.float32), k)
    _equal(e, np.asarray(got["e"]).astype(np.float32).reshape(N, -1))

    jstate = {"params": jax.tree.map(
        lambda a: (np.asarray(a).astype(np.float32) * 3).astype(
            jnp.bfloat16), got["params"]),
        "e": (np.asarray(got["e"]).astype(np.float32) - 1).astype(
            jnp.bfloat16)}
    jck.save_checkpoint(tmp_path / "jax", 2, jstate)
    s2 = _port_setup(param_dtype="bfloat16", ef_dtype="bfloat16")
    e2 = torch.zeros_like(e)
    step, _ = ck.restore_checkpoint(
        tmp_path / "jax", {"params": s2.model.params(),
                           "e": e2.view(N, 1, -1)})
    assert step == 2
    for k, v in s2.model.params().items():
        _equal(v, np.asarray(jstate["params"][k]).astype(np.float32), k)
    _equal(e2, np.asarray(jstate["e"]).astype(np.float32).reshape(N, -1))


@pytest.mark.parametrize("old,new,flat", (((4, 1), (2, 1), 96),
                                          ((2, 1), (4, 1), 160)))
def test_elastic_rescale_keeps_bf16_e(old, new, flat):
    """A bf16 e across a device-count change: JAX's mapping (on its
    ml_dtypes bf16 array), bit for bit, and still bf16."""
    rng = np.random.default_rng(flat)
    e_old = torch.from_numpy(rng.standard_normal(old + (128,)).astype(
        np.float32)).to(BF16)
    got = ck.elastic_rescale_ef(e_old, old, new, flat)
    want = jck.elastic_rescale_ef(
        np.asarray(jnp.asarray(e_old.float().numpy()).astype(jnp.bfloat16)),
        old, new, flat)
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    assert tuple(got.shape) == want.shape
    _equal(got, np.asarray(want).astype(np.float32))


# --- serving a bf16-theta spec ----------------------------------------------

def _serve_spec(param_dtype):
    spec = REGISTRY["gemma2-2b"]
    return dataclasses.replace(spec, smoke=dataclasses.replace(
        spec.smoke, dtype="bfloat16", param_dtype=param_dtype))


def test_serve_bf16_theta_equals_f32_theta_of_the_same_values():
    """`build_serve_setup` of a spec whose config carries param_dtype
    "bfloat16": theta is bf16 (no gradient buffer), and prefill and 4
    decode steps give the bits of the f32-theta model holding the same
    (bf16-rounded) values, whose casts to the bf16 compute are exact: the
    logits and every cache leaf bit for bit, the caches bf16."""
    from repro_torch.launch.serve import build_serve_setup
    runs = []
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 16))).long()
    with one_thread():
        for pdt in ("bfloat16", "float32"):
            s = build_serve_setup(_serve_spec(pdt), ShapeCfg("prefill", 16,
                                                             2),
                                  smoke=True, device="cpu")
            assert s.model.grad is None
            s.model.init_(0)
            if pdt == "float32":               # the bf16 theta's values
                s.model.theta.copy_(s.model.theta.to(BF16))
            logits, caches = s.prefill_step(toks)
            outs = [logits]
            nxt = logits.argmax(-1)[:, None]
            for i in range(4):
                logits, caches = s.decode_step(caches, nxt, 16 + i)
                outs.append(logits)
                nxt = logits.argmax(-1)[:, None]
            runs.append((s.model.theta, outs, caches))
    assert runs[0][0].dtype == BF16
    _equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        _equal(a, b)
    for k in ("k", "v"):
        assert runs[0][2]["kv"][k].dtype == BF16
        _equal(runs[0][2]["kv"][k], runs[1][2]["kv"][k])


def test_serve_bf16_theta_prefill_matches_jax(monkeypatch):
    """The bf16-theta prefill against JAX's jitted prefill with
    param_dtype "bfloat16" (its attention core the Pallas kernel in
    interpret mode, as tests/test_torch_serve.py runs it): logits and
    caches within 4 bf16 ulps of the largest magnitude (2**-6), that
    file's bf16 tolerance."""
    import repro.nn.layers as jlayers
    from repro.configs.gemma2_2b import ARCH as JAX_ARCH
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro_torch.launch.device_parity import rel_gap
    jcfg = dataclasses.replace(JAX_ARCH.smoke, dtype="bfloat16",
                               param_dtype="bfloat16")

    def pallas_core(q, k, v, cfg, q_pos, k_pos, w_eff):
        g = cfg.num_heads // cfg.num_kv_heads
        args = tuple(jnp.swapaxes(t, 1, 2) for t in (q, k, v))
        local, glob = (jflash(*args, softcap=cfg.attn_softcap, window=w,
                              groups=g, interpret=True)
                       for w in (cfg.sliding_window, 0))
        return jnp.swapaxes(jnp.where(w_eff == cfg.sliding_window, local,
                                      glob), 1, 2)
    monkeypatch.setattr(jlayers, "_attn_core", pallas_core)
    jm = JModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks))
    pm = Model(_serve_spec("bfloat16").smoke, device="cpu", with_grad=False)
    with one_thread():
        pm.init_(0)
        pl, pc = pm.prefill(torch.from_numpy(toks).long())
    want = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(BF16)
    assert pl.dtype == BF16 and rel_gap(want, pl) <= 2.0 ** -6
    jc = params_from_jax(jax.tree.map(np.asarray, jc))
    for k in ("k", "v"):
        assert rel_gap(jc[f"kv/{k}"], pc["kv"][k]) <= 2.0 ** -6
