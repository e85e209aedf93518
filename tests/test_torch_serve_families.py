"""The port's serving path for every arch beyond gemma2-2b against the JAX
package, on the smoke configs, on one torch thread: phi3-medium-14b
(swiglu, untied head), nemotron-4-15b (relu2, LayerNorm), qwen1.5-110b
(qkv bias), llava-next-34b and musicgen-large (the embeddings input),
olmoe-1b-7b (MoE), deepseek-v2-lite-16b (MLA + MoE), zamba2-2.7b (Mamba2
groups and a shared attention block) and xlstm-1.3b (mLSTM and sLSTM),
each from JAX's θ0 (`Model.init_(0)`, bit for bit) on B = 4 prompts of
S = 32 tokens (seeded bf16 embeddings of scale 0.02 for the embeddings
archs).

  - prefill: the last position's logits and every cache leaf against
    JAX's jitted `prefill` (caches in the compute dtype); the cache tree
    (nesting, shapes, dtypes) is JAX's and the positions are exact;
  - decode: 4 steps at positions S..S+3 fed seeded tokens (embeddings),
    the port from its own prefill caches against JAX from its own, and
    the port from JAX's prefill caches carried over by
    `convert.caches_from_jax`: logits and every cache leaf after each
    step; the KV and MLA rings of length S wrap at once (slot pos % S
    evicts positions 0..3); the greedy tokens equal wherever JAX's top-2
    gap exceeds the tolerance;
  - empty caches: `init_caches` equals JAX's bit for bit (the f32 conv
    tails of the Mamba2 cache included), and 12 teacher-forced f32 decode
    steps into empty f32 rings of 8 slots (wrapping) equal JAX's;
  - MoE routing at decode's T = B (olmoe, deepseek; capacity factor 0.5,
    B 4, where the floor of 8 slots decides and nothing drops, and B 32,
    where assignments drop): each MoE layer's input of a decode step
    through JAX's routing; the port's gate ids from its own router equal
    JAX's, and fed JAX's probabilities its sorted order, slots, keep
    flags, kept counts and dropped count equal JAX's exactly; the layer's
    output within the f32 tolerance;
  - `build_serve_setup` matches JAX's (cache_len, batch, seq_len) and the
    prefill cache tree's shapes and dtypes equal JAX's `eval_shape`;
  - `launch.serve_batched` (the port of `examples/serve_batched.py`):
    its prompts are JAX's `randint(PRNGKey(0), ...)`, and its sampled
    tokens are JAX's example loop's (run here on a one-device mesh):
    equal in f32; in bf16 (the example's dtype) equal up to JAX's first
    near tie, and teacher-forced on JAX's tokens the port's greedy pick
    equals JAX's at every step where JAX's top-2 gap is clear: at an
    exact bf16 tie JAX itself picks otherwise on its 4 x 2 example mesh
    than on one device; the embeddings archs raise ValueError; --metrics
    writes records and a trace that pass the port's validators.

Tolerances (stated here, as tests/test_torch_serve.py and
test_torch_families.py set them):
  - f32: the attention families (dense, moe, deepseek) within 2e-6 of
    the largest magnitude of JAX's tensor (both sum in other orders;
    measured below 1e-6); the recurrent families (hybrid, xlstm) within
    1e-5 of it, `launch/device_parity.py`'s f32 serving tolerance:
    XLA:CPU's exp, log1p and silu differ from torch's by an ulp in about
    half the entries, and the states carry those ulps through the stack
    (measured up to 3.1e-6 on zamba2's decode logits, so the module
    bound of `assert_close`, atol 1e-6 of the largest magnitude
    elementwise, is too tight for a whole stack);
  - bf16: the attention families within 4 bf16 ulps of the largest
    magnitude (2**-6), against JAX's prefill with its `_attn_core`
    monkeypatched to the Pallas kernel (interpret mode) inside the test,
    as tests/test_torch_serve.py does; the MoE archs route by JAX's own
    gate ids in both models (each call's ids recorded from JAX's run):
    their smoke routers are near uniform, so a hidden state one bf16
    rounding away picks other experts (JAX's own bf16 caches differ from
    its f32 ones by 12-19% through those flips); the recurrent families
    within 5% of the largest magnitude or twice JAX's own bf16 error
    against its f32 run of the same weights and inputs
    (`assert_close`'s bf16 bound);
  - cache positions, routing and tokens exact.  JAX runs under `jax.jit`.
"""
import collections
import contextlib
import dataclasses
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as jlayers
from _torch_cases import one_thread
from repro.compat import make_mesh
from repro.configs import REGISTRY as JREG
from repro.configs.common import ShapeCfg as JaxShape
from repro.kernels.flash_attention import flash_attention as jflash
from repro.launch.serve import build_serve_setup as jax_serve_setup
from repro.nn import Model as JModel
from repro.nn import moe as JMOE
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.convert import (caches_from_jax, caches_to_jax,
                                 params_from_jax)
from repro_torch.core import prng
from repro_torch.launch import serve_batched
from repro_torch.launch.device_parity import rel_gap
from repro_torch.launch.serve import build_serve_setup
from repro_torch.nn import moe as MOE
from repro_torch.nn.models import Model
from repro_torch.obs import read_jsonl, validate_chrome_trace, \
    validate_record
from test_torch_families import assert_close
from test_torch_moe import _jax_parts

ARCHS = ("phi3-medium-14b", "nemotron-4-15b", "qwen1.5-110b",
         "llava-next-34b", "musicgen-large", "olmoe-1b-7b",
         "deepseek-v2-lite-16b", "zamba2-2.7b", "xlstm-1.3b")
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
DTYPES = ("float32", "bfloat16")
B, S, STEPS = 4, 32, 4
RING, FRESH_STEPS = 8, 12
F32_TOL, RECURRENT_F32_TOL, BF16_TOL = 2e-6, 1e-5, 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module on one torch thread (`_torch_cases.one_thread`)."""
    with one_thread():
        yield


def _cfg(registry, arch: str, dtype: str):
    return dataclasses.replace(registry[arch].smoke, dtype=dtype)


def _recurrent(arch: str) -> bool:
    return REGISTRY[arch].smoke.family in ("hybrid", "xlstm")


def _inputs(cfg, n: int, rng) -> np.ndarray:
    """(B, n) int32 tokens, or (B, n, d) bf16 embeddings of scale 0.02."""
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return np.asarray(jnp.asarray(rng.standard_normal(
        (B, n, cfg.d_model)).astype(np.float32) * 0.02, jnp.bfloat16))


def _torch_in(a: np.ndarray) -> torch.Tensor:
    t = caches_from_jax(a)
    return t.long() if a.dtype == np.int32 else t


def _pallas_core(q, k, v, cfg, q_pos, k_pos, w_eff):
    """JAX's `_attn_core` on the prefill's full (S, S) block through the
    Pallas kernel (interpret mode); these archs have no window."""
    args = tuple(jnp.swapaxes(t, 1, 2) for t in (q, k, v))
    out = jflash(*args, softcap=cfg.attn_softcap, window=0,
                 groups=cfg.num_heads // cfg.num_kv_heads, interpret=True)
    return jnp.swapaxes(out, 1, 2)


def _recording_moe(rec: list):
    """JAX's `apply_moe` that also records each call's gate ids (T, k),
    computed by the same steps on the same values (an ordered callback,
    so scanned layers come in order)."""
    apply = JMOE.apply_moe

    def f(p, x, cfg):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(xt.astype(jnp.float32)
                               @ p["router"].astype(jnp.float32), axis=-1)
        idx = jax.lax.top_k(probs, cfg.moe_top_k)[1]
        jax.debug.callback(lambda a: rec.append(np.asarray(a)), idx,
                           ordered=True)
        return apply(p, x, cfg)
    return f


def _moe_layers(cfg) -> int:
    return cfg.num_layers - (cfg.family == "deepseek") if cfg.moe_experts \
        else 0


@functools.lru_cache(maxsize=None)
def _jax(arch: str, dtype: str) -> SimpleNamespace:
    """JAX's run (jitted): θ0, the prompts and decode feeds, the prefill
    (logits, caches in the compute dtype) and STEPS decode steps from its
    caches at positions S.., each (logits, caches) as numpy; `ids`, the
    MoE layers' gate ids of the prefill and of each step, in call order
    (bf16 MoE archs).  bf16 prefills run the Pallas core; bf16 runs of the
    recurrent families also carry `ref32`, the f32 run of the same
    weights and inputs."""
    cfg = _cfg(JREG, arch, dtype)
    m = JModel(cfg)
    params = jax.jit(m.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = _inputs(cfg, S, rng)
    feeds = [_inputs(cfg, 1, rng) for _ in range(STEPS)]
    rec: list = []
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "bfloat16":
            mp.setattr(jlayers, "_attn_core", _pallas_core)
            if cfg.moe_experts:
                mp.setattr(JMOE, "apply_moe", _recording_moe(rec))
        logits, caches = jax.jit(lambda p, x: m.prefill(
            p, x, cache_dtype=jnp.dtype(dtype)))(params, jnp.asarray(prompts))
        out = SimpleNamespace(params=params, prompts=prompts, feeds=feeds,
                              ref32=None, steps=[])
        out.prefill = (np.asarray(logits), jax.tree.map(np.asarray, caches))
        dec = jax.jit(m.decode_step)
        for t, feed in enumerate(feeds):
            lg, caches = dec(params, caches, jnp.asarray(feed), S + t)
            out.steps.append((np.asarray(lg),
                              jax.tree.map(np.asarray, caches)))
        jax.effects_barrier()
    n = _moe_layers(cfg)
    assert len(rec) == (n * (STEPS + 1) if rec else 0)
    out.ids = [rec[i * n:(i + 1) * n] for i in range(STEPS + 1)] if rec \
        else None
    if dtype == "bfloat16" and _recurrent(arch):
        out.ref32 = _ref32(arch, params, prompts, feeds)
    return out


def _ref32(arch, params, prompts, feeds) -> SimpleNamespace:
    """JAX's f32 run (f32 caches) of the same weights and inputs."""
    m = JModel(_cfg(JREG, arch, "float32"))
    logits, caches = jax.jit(lambda p, x: m.prefill(
        p, x, cache_dtype=jnp.float32))(params, jnp.asarray(prompts))
    out = SimpleNamespace(prefill=(np.asarray(logits),
                                   jax.tree.map(np.asarray, caches)))
    dec = jax.jit(m.decode_step)
    out.steps = []
    for t, feed in enumerate(feeds):
        lg, caches = dec(params, caches, jnp.asarray(feed), S + t)
        out.steps.append((np.asarray(lg), jax.tree.map(np.asarray, caches)))
    return out


def _port(arch: str, dtype: str, ref) -> Model:
    pm = Model(_cfg(REGISTRY, arch, dtype), device="cpu", with_grad=False)
    pm.load_params(params_from_jax(jax.tree.map(np.asarray, ref.params)))
    return pm


def _leaves(tree) -> list:
    """(path, leaf) in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}".rstrip("/"), x) for k in sorted(tree)
                for p, x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [(f"{i}/{p}".rstrip("/"), x) for i, v in enumerate(tree)
                for p, x in _leaves(v)]
    return [("", tree)]


def _close(arch, dtype, got, want, what, want32=None) -> None:
    """The module docstring's tolerance for one tensor of `arch`."""
    got = got.detach()
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    if not np.issubdtype(want.dtype, np.floating) and \
            want.dtype.name != "bfloat16":
        assert torch.equal(got, torch.from_numpy(want.copy())), what
        return
    if _recurrent(arch) and dtype == "bfloat16":
        assert_close(got, want, dtype, what, want32)
        return
    tol = (BF16_TOL if dtype == "bfloat16" else
           RECURRENT_F32_TOL if _recurrent(arch) else F32_TOL)
    gap = rel_gap(caches_from_jax(want), got)
    assert torch.isfinite(got.float()).all() and gap <= tol, \
        f"{what}: {gap:.3e} (tol {tol:.1e})"


def _check(arch, dtype, got_logits, got_caches, want, what, ref32=None):
    """Logits and every cache leaf (the same tree, dtypes and shapes) of
    one step against JAX's (logits, caches) `want`."""
    wl, wc = want
    _close(arch, dtype, got_logits, wl, f"{what} logits",
           None if ref32 is None else ref32[0])
    got, exp = _leaves(got_caches), _leaves(wc)
    assert [p for p, _ in got] == [p for p, _ in exp], what
    w32 = [None] * len(exp) if ref32 is None else \
        [x for _, x in _leaves(ref32[1])]
    for (path, g), (_, w), r in zip(got, exp, w32):
        assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name, \
            f"{what} {path}: {g.dtype} vs {np.asarray(w).dtype}"
        _close(arch, dtype, g, w, f"{what} cache {path}", r)
    _tokens_agree(arch, dtype, got_logits, wl, what)


def _tokens_agree(arch, dtype, got, want, what) -> None:
    """Greedy tokens equal wherever JAX's top-2 gap exceeds the tolerance
    (in units of the largest magnitude)."""
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    top2 = np.sort(w, -1)[:, -2:]
    tol = (0.05 if _recurrent(arch) and dtype == "bfloat16" else
           1e-5 if dtype == "float32" else BF16_TOL)
    sure = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(w).max()
    np.testing.assert_array_equal(got.float().argmax(-1).numpy()[sure],
                                  w.argmax(-1)[sure], err_msg=what)


@contextlib.contextmanager
def _routed(ids):
    """The port's MoE layers route by `ids` (JAX's gate ids, one (T, k)
    array per call, in call order; None: by their own router)."""
    if ids is None:
        yield
        return
    queue = collections.deque(ids)

    def top_k(probs, k):
        idx = torch.from_numpy(queue.popleft().copy()).long()
        assert tuple(idx.shape) == (probs.shape[0], k)
        return idx
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MOE, "top_k", top_k)
        yield
    assert not queue, "JAX's run made more MoE calls than the port's"


def _ref(ref, i):
    """JAX's f32 reference of step i (0: the prefill), if any."""
    if ref.ref32 is None:
        return None
    return ref.ref32.prefill if i == 0 else ref.ref32.steps[i - 1]


def _flat(ids):
    return None if ids is None else [a for step in ids for a in step]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    ref = _jax(arch, dtype)
    pm = _port(arch, dtype, ref)
    with _routed(None if ref.ids is None else ref.ids[0]):
        logits, caches = pm.prefill(_torch_in(ref.prompts),
                                    cache_dtype=getattr(torch, dtype))
    _check(arch, dtype, logits, caches, ref.prefill, "prefill", _ref(ref, 0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_ports_prefill_matches_jax(arch, dtype):
    """Each side decodes from its own prefill's caches."""
    ref = _jax(arch, dtype)
    pm = _port(arch, dtype, ref)
    with _routed(_flat(ref.ids)):
        _, caches = pm.prefill(_torch_in(ref.prompts),
                               cache_dtype=getattr(torch, dtype))
        for t, feed in enumerate(ref.feeds):
            logits, out = pm.decode_step(caches, _torch_in(feed), S + t)
            assert out is caches                  # updated in place
            _check(arch, dtype, logits, caches, ref.steps[t],
                   f"decode step {t}", _ref(ref, t + 1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_jax_caches_matches_jax(arch, dtype):
    """The port decodes from JAX's prefill caches, carried over by
    `caches_from_jax` (every bit; `caches_to_jax` gives them back)."""
    ref = _jax(arch, dtype)
    pm = _port(arch, dtype, ref)
    caches = caches_from_jax(ref.prefill[1])
    for (_, a), (_, b) in zip(_leaves(caches_to_jax(caches)),
                              _leaves(ref.prefill[1])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == np.ascontiguousarray(b).tobytes()
    with _routed(None if ref.ids is None else _flat(ref.ids[1:])):
        for t, feed in enumerate(ref.feeds):
            logits, caches = pm.decode_step(caches, _torch_in(feed), S + t)
            _check(arch, dtype, logits, caches, ref.steps[t],
                   f"decode step {t} from JAX's caches", _ref(ref, t + 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_and_fresh_decode_match_jax(arch):
    """`init_caches(B, RING)` equals JAX's bit for bit (bf16 rings, the
    default); then FRESH_STEPS teacher-forced f32 decode steps from empty
    f32 caches (the rings of RING slots wrap) against JAX's."""
    jcfg = _cfg(JREG, arch, "float32")
    m = JModel(jcfg)
    params = jax.jit(m.init)(jax.random.PRNGKey(0))
    want = jax.tree.map(np.asarray, m.init_caches(B, RING))
    pm = _port(arch, "float32", SimpleNamespace(params=params))
    got = pm.init_caches(B, RING)
    gl, wl = _leaves(got), _leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = caches_from_jax(w)
        assert g.dtype == w.dtype and torch.equal(g, w), path
    rng = np.random.default_rng(1)
    feeds = _inputs(jcfg, FRESH_STEPS, rng)
    dec = jax.jit(m.decode_step)
    jc = m.init_caches(B, RING, dtype=jnp.float32)
    got = pm.init_caches(B, RING, dtype=torch.float32)
    for t in range(FRESH_STEPS):
        feed = feeds[:, t:t + 1]
        jl, jc = dec(params, jc, jnp.asarray(feed), t)
        logits, got = pm.decode_step(got, _torch_in(feed), t)
        _check(arch, "float32", logits, got,
               (np.asarray(jl), jax.tree.map(np.asarray, jc)),
               f"fresh decode step {t}")


@pytest.mark.parametrize("batch", [4, 32])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_exact_at_decode(arch, batch):
    """One f32 decode step of `batch` sequences from empty caches at
    capacity factor 0.5 (T = batch tokens a layer: C = 8, the floor, at
    both sizes); each MoE layer's input is routed by JAX's steps
    (`test_torch_moe._jax_parts`, held bit for bit against JAX's
    `apply_moe`) and by the port's."""
    jcfg = dataclasses.replace(_cfg(JREG, arch, "float32"),
                               capacity_factor=0.5)
    pcfg = dataclasses.replace(_cfg(REGISTRY, arch, "float32"),
                               capacity_factor=0.5)
    params = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))
    pm = Model(pcfg, device="cpu", with_grad=False)
    pm.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    seen = []
    apply, top_k = MOE.apply_moe, MOE.top_k

    def recording(p, x, cfg):
        out = apply(p, x, cfg)
        seen.append((x.clone(), p, out))
        return out
    ids = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MOE, "apply_moe", recording)
        mp.setattr(MOE, "top_k", lambda probs, k: ids.append(
            top_k(probs, k)) or ids[-1])
        feed = np.random.default_rng(3).integers(
            0, jcfg.vocab_size, (batch, 1)).astype(np.int32)
        pm.decode_step(pm.init_caches(batch, RING), _torch_in(feed), 0)
    layers = params["blocks"]["moe"]
    assert len(seen) == _moe_layers(jcfg) == len(ids)
    dropped = 0
    for l, ((x, p, (out, _, n_drop)), own) in enumerate(zip(seen, ids)):
        jp = jax.tree.map(lambda a: a[l], layers)
        jx = jnp.asarray(x.numpy())
        parts = jax.jit(lambda p, x: _jax_parts(p, x, jcfg))(jp, jx)
        T, k = x.shape[0] * x.shape[1], jcfg.moe_top_k
        C = JMOE.capacity(T, jcfg)
        assert C == MOE.capacity(T, pcfg) == 8
        np.testing.assert_array_equal(own.numpy(),
                                      np.asarray(parts["gate_idx"]))
        probs = torch.from_numpy(np.array(parts["probs"]))
        _, r = MOE.route(probs, top_k(probs, k), pcfg, C)
        for name in ("order", "slot", "keep", "counts", "gate_idx"):
            np.testing.assert_array_equal(
                getattr(r, name).numpy(), np.asarray(parts[name]),
                err_msg=f"layer {l} {name}")
        kept = int(np.asarray(parts["keep"]).sum())
        assert int(r.dropped) == int(n_drop) == T * k - kept
        dropped += T * k - kept
        jout, _ = jax.jit(lambda p, x: JMOE.apply_moe(p, x, jcfg))(jp, jx)
        gap = rel_gap(torch.from_numpy(np.asarray(jout)), out)
        assert gap <= F32_TOL, (l, gap)
    assert (dropped > 0) == (batch > B)      # the floor of 8 slots at B 4


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_setup_matches_jax(arch):
    """cache_len, batch and seq_len equal JAX's `build_serve_setup` on a
    one-device mesh, and the prefill's cache tree (nesting, shapes,
    dtypes) equals JAX's `eval_shape` of its prefill."""
    shape = ("prefill", S, B)
    want = jax_serve_setup(JREG[arch], make_mesh((1, 1), ("data", "model")),
                           JaxShape(*shape), smoke=True)
    got = build_serve_setup(REGISTRY[arch], ShapeCfg(*shape), smoke=True,
                            device="cpu")
    assert (got.cache_len, got.batch, got.seq_len) == \
        (want.cache_len, want.batch, want.seq_len)
    cfg = REGISTRY[arch].smoke
    inp = (torch.zeros((B, S), dtype=torch.long) if cfg.input_mode ==
           "tokens" else torch.zeros((B, S, cfg.d_model),
                                     dtype=torch.bfloat16))
    spec = want.input_specs("prefill")
    jshape = jax.eval_shape(want.prefill_step, spec["params"],
                            spec["inputs"])
    logits, caches = got.prefill_step(inp)
    assert tuple(logits.shape) == jshape[0].shape
    gl, wl = _leaves(caches), _leaves(jshape[1])
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path


def _jax_example(dtype: str, prompts: np.ndarray, prompt_len: int,
                 teacher=None):
    """`examples/serve_batched.py`'s loop on a one-device mesh (its own
    (4, 2) mesh needs 8 host devices): θ0 and caches as the example makes
    them; returns (sampled tokens, the logits of each sampled step).  With
    `teacher` (B, new) the sampled steps are fed those tokens."""
    spec = dataclasses.replace(JREG["phi3-medium-14b"],
                               smoke=_cfg(JREG, "phi3-medium-14b", dtype))
    Bt, total = prompts.shape
    setup = jax_serve_setup(spec, make_mesh((1, 1), ("data", "model")),
                            JaxShape("decode", total, Bt), smoke=True)
    params = jax.jit(setup.model.init)(jax.random.PRNGKey(0))
    caches = setup.model.init_caches(Bt, total)
    dec = jax.jit(setup.decode_step)
    tok, gen, logs = jnp.asarray(prompts[:, :1]), [], []
    for t in range(total - 1):
        logits, caches = dec(params, caches, tok, jnp.int32(t))
        if t < prompt_len - 1:
            tok = jnp.asarray(prompts[:, t + 1:t + 2])
        else:
            logs.append(np.asarray(logits.astype(jnp.float32)))
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            gen.append(np.asarray(tok))
            if teacher is not None:
                tok = jnp.asarray(teacher[:, len(gen) - 1:len(gen)])
    return np.concatenate(gen, 1), np.stack(logs)


def _args(**kw):
    ns = serve_batched.build_parser().parse_args(["--device", "cpu"])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_serve_batched_prompts_are_jax_randint():
    """The example's prompts: jax.random.randint(PRNGKey(0), (4, 32), 0,
    vocab), bit for bit, at the smoke vocab and at phi3's full one."""
    for vocab in (REGISTRY["phi3-medium-14b"].smoke.vocab_size,
                  REGISTRY["phi3-medium-14b"].config.vocab_size):
        want = jax.random.randint(jax.random.PRNGKey(0), (4, 32), 0, vocab)
        np.testing.assert_array_equal(
            prng.randint(prng.PRNGKey(0), (4, 32), 0, vocab),
            np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_batched_tokens_match_jax_example(dtype, capsys):
    args = _args()
    total = args.prompt_len + args.new_tokens
    prompts = prng.randint(prng.PRNGKey(0), (args.batch, total), 0,
                           REGISTRY["phi3-medium-14b"].smoke.vocab_size)
    spec = dataclasses.replace(
        REGISTRY["phi3-medium-14b"],
        smoke=_cfg(REGISTRY, "phi3-medium-14b", dtype))
    got = serve_batched.run(args, spec=spec)["tokens"]
    assert got.shape == (args.batch, args.new_tokens)
    assert "sampled token ids:" in capsys.readouterr().out
    want, logs = _jax_example(dtype, prompts, args.prompt_len)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    # bf16: equal up to each row's first near tie of JAX's ...
    top2 = np.sort(logs, -1)[..., -2:]                  # (new, B, 2)
    near = (top2[..., 1] - top2[..., 0]).T <= \
        2 * BF16_TOL * np.abs(logs).max()               # (B, new)
    for b in range(args.batch):
        stop = int(np.argmax(near[b])) if near[b].any() else args.new_tokens
        np.testing.assert_array_equal(got[b, :stop], want[b, :stop])
    # ... and teacher-forced on JAX's tokens, the same pick where it is
    # clear
    pm_setup = build_serve_setup(spec, ShapeCfg("decode", total,
                                                args.batch), smoke=True,
                                 device="cpu")
    pm_setup.model.init_(0)
    caches = pm_setup.model.init_caches(args.batch, total)
    tok = torch.from_numpy(prompts[:, :1]).long()
    picks = []
    for t in range(total - 1):
        logits, caches = pm_setup.decode_step(caches, tok, t)
        if t < args.prompt_len - 1:
            tok = torch.from_numpy(prompts[:, t + 1:t + 2]).long()
        else:
            picks.append(logits.float().argmax(-1).numpy())
            tok = torch.from_numpy(want[:, len(picks) - 1:len(picks)]
                                   ).long()
    picks = np.stack(picks, 1)
    np.testing.assert_array_equal(picks[~near], want[~near])


def test_serve_batched_refuses_embeddings_input():
    for arch in ("musicgen-large", "llava-next-34b"):
        with pytest.raises(ValueError, match="embeddings"):
            serve_batched.run(_args(arch=arch))


def test_serve_batched_metrics(tmp_path, capsys):
    """--metrics: 2 requests of 3 sequences, records and trace valid."""
    res = serve_batched.run(_args(metrics=True, requests=2, batch=3,
                                  prompt_len=5, new_tokens=3,
                                  metrics_dir=str(tmp_path)))
    assert res["tokens"].shape == (3, 3)
    recs = read_jsonl(res["jsonl"])
    for r in recs:
        validate_record(r)
    kinds = [r["kind"] for r in recs]
    assert kinds.count("serve_request") == 2 and "serve_summary" in kinds
    summary = [r for r in recs if r["kind"] == "serve_summary"][0]
    assert summary["decode_token_ms"]["count"] == 2 * (5 + 3 - 1)
    validate_chrome_trace(json.loads(open(res["trace"]).read()))
    assert "serve telemetry over 2 request(s)" in capsys.readouterr().out
