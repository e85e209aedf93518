"""The port's serving path against the JAX package: the plain flash
attention against JAX's Pallas kernel (interpret mode) and its jnp
reference, the wrapper's checks, bf16 arrays through `convert`, and
`Model.prefill` / `decode_step` against JAX's on gemma2's smoke config
(S = 32 > the local window of 8) with the same weights.

Tolerances:
- flash attention in f32: rtol 2e-4, atol 2e-5, JAX's own kernel test's
  (`tests/test_kernels.py`); in bf16 one bf16 ulp of the larger magnitude
  (+2e-5): both sides sum in f32 in other orders and round once to bf16
  (`flash_attention.allowed_error`).
- the model in f32: logits and caches within 2e-6 of the largest
  magnitude (the CPU sums in another order in each framework; measured
  gaps are 2.6e-7 on logits and 4e-7 on caches); f32 rounded to bf16
  caches within one bf16 ulp elementwise.
- the model in bf16, against JAX's prefill with its attention core
  swapped for the Pallas kernel (as `repro.nn.layers.attn_train`'s
  docstring describes for real hardware): within 4 bf16 ulps of the
  largest magnitude (2**-6): the frameworks round bf16 products after
  their own f32 sums, and a flipped last bit moves everything downstream
  (measured: one ulp on logits and caches).
- greedy tokens equal wherever JAX's top-2 logit gap exceeds the
  tolerance; cache positions exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as jlayers
from _torch_cases import flash_inputs
from repro.compat import make_mesh
from repro.configs.common import SMOKE_DECODE
from repro.configs.common import ShapeCfg as JaxShape
from repro.configs.gemma2_2b import ARCH as JAX_ARCH
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.launch.serve import build_serve_setup as jax_serve_setup
from repro.nn import Model as JaxModel
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.common import launches
from repro_torch.launch.device_parity import rel_gap, serve_parity
from repro_torch.launch.serve import LONG_SEQ, build_serve_setup
from repro_torch.nn.models import Model

SPEC = REGISTRY["gemma2-2b"]
B, S = 4, 32
F32_TOL, BF16_TOL = 2e-6, 2.0 ** -6


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _torch(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _within(port: torch.Tensor, want: torch.Tensor) -> None:
    err = (port.float() - want.float()).abs()
    assert bool((err <= fa.allowed_error(port, want)).all()), \
        err.max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap,window,groups", [
    (0.0, 0, 1), (50.0, 0, 2), (0.0, 64, 2), (30.0, 32, 4)])
def test_plain_flash_matches_pallas_and_jnp_ref(softcap, window, groups,
                                                dtype):
    q, k, v = flash_inputs(2, 2, groups, 512, 64, dtype, seed=groups)
    port = fa.flash_attention(q, k, v, softcap=softcap, window=window,
                              groups=groups)
    args = tuple(map(_jnp, (q, k, v)))
    pallas = jflash(*args, softcap=softcap, window=window, groups=groups,
                    interpret=True)
    jnp_ref = jref.flash_attention_ref(*args, softcap=softcap,
                                       window=window, groups=groups)
    for want in (pallas, jnp_ref):
        _within(port, _torch(want, port.dtype))


@pytest.mark.parametrize("S_,hd,window", [
    (64, 288, 0), (64, 288, 16), (100, 64, 8), (1, 16, 0), (300, 16, 0),
    (300, 16, 40)])
def test_plain_flash_any_S_and_hd_288(S_, hd, window):
    """hd = 288 (gemma2) and any S against the jnp reference, and against
    the Pallas kernel where its grid covers every row (S a multiple of
    min(256, S)); at S = 300 it never writes rows 256..299 (ROADMAP C9)."""
    q, k, v = flash_inputs(1, 2, 2, S_, hd, "float32", seed=S_)
    port = fa.flash_attention(q, k, v, softcap=50.0, window=window,
                              groups=2)
    args = tuple(map(_jnp, (q, k, v)))
    _within(port, _torch(jref.flash_attention_ref(
        *args, softcap=50.0, window=window, groups=2), torch.float32))
    if S_ % min(256, S_) == 0:
        _within(port, _torch(jflash(*args, softcap=50.0, window=window,
                                    groups=2, interpret=True),
                             torch.float32))


def test_flash_wrapper_checks():
    q = torch.zeros((1, 4, 8, 16))
    kv = torch.zeros((1, 2, 8, 16))
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), kv.double(), kv.double(), groups=2)
    with pytest.raises(TypeError):
        fa.flash_attention(q, kv.bfloat16(), kv.bfloat16(), groups=2)
    with pytest.raises(ValueError):                     # H != groups * Hkv
        fa.flash_attention(q, kv, kv, groups=1)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv, groups=3)
    with pytest.raises(ValueError):
        z = torch.zeros((1, 2, 8, fa.MAX_HEAD_DIM + 1))
        fa.flash_attention(z, z, z)
    with pytest.raises(ValueError):
        fa.flash_attention(q[0], kv, kv, groups=2)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv, groups=2, window=-1)
    with pytest.raises(ValueError):                     # device mismatch
        fa.flash_attention(q, kv.to("meta"), kv, groups=2)
    # the meta device (the dry run's): checked as for the card, an output
    # of q's shape and dtype, no launch
    before = fa.launches["flash_attention"]
    out = fa.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"),
                             groups=2)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert fa.launches["flash_attention"] == before
    with pytest.raises(ValueError):                     # bf16 needs hd % 8
        z = torch.zeros((1, 2, 8, 12), dtype=torch.bfloat16, device="meta")
        fa.flash_attention(z, z, z)
    with pytest.raises(RuntimeError):                   # forward only
        fa.flash_attention(q.requires_grad_(), kv, kv, groups=2)
    with torch.no_grad():
        assert fa.flash_attention(q, kv, kv, groups=2).shape == q.shape


def _params(cfg):
    return jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0)))


def _prompts(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _pallas_core(q, k, v, cfg, q_pos, k_pos, w_eff):
    """JAX's `_attn_core` on the prefill's full (S, S) block through the
    Pallas kernel.  The window is traced inside JAX's layer scan, so both
    of gemma2's windows run statically and `w_eff` picks one."""
    g = cfg.num_heads // cfg.num_kv_heads
    args = tuple(jnp.swapaxes(t, 1, 2) for t in (q, k, v))
    local, glob = (jflash(*args, softcap=cfg.attn_softcap, window=w,
                          groups=g, interpret=True)
                   for w in (cfg.sliding_window, 0))
    return jnp.swapaxes(jnp.where(w_eff == cfg.sliding_window, local, glob),
                        1, 2)


def _both_prefill(dtype, monkeypatch, cache_dtype="bfloat16"):
    """JAX's jitted prefill and the port's, from the same weights and
    prompts; in bf16 JAX's attention core is the Pallas kernel."""
    jcfg = dataclasses.replace(JAX_ARCH.smoke, dtype=dtype)
    pcfg = dataclasses.replace(SPEC.smoke, dtype=dtype)
    params, toks = _params(jcfg), _prompts(jcfg)
    if dtype == "bfloat16":
        monkeypatch.setattr(jlayers, "_attn_core", _pallas_core)
    jm = JaxModel(jcfg)
    jl, jc = jax.jit(lambda p, t: jm.prefill(
        p, t, cache_dtype=getattr(jnp, cache_dtype)))(params,
                                                      jnp.asarray(toks))
    pm = Model(pcfg, device="cpu")
    pm.load_params(params_from_jax(params))
    pl, pc = pm.prefill(torch.from_numpy(toks).long(),
                        cache_dtype=getattr(torch, cache_dtype))
    jc = params_from_jax(jax.tree.map(np.asarray, jc))
    return (jm, params, jl, jc), (pm, pl, pc)


def _close(port: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    assert port.shape == want.shape and port.dtype == want.dtype
    assert rel_gap(want, port) <= tol, rel_gap(want, port)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax_f32(monkeypatch, cache_dtype):
    (_, _, jl, jc), (_, pl, pc) = _both_prefill("float32", monkeypatch,
                                               cache_dtype)
    _close(pl, _torch(jl, torch.float32), F32_TOL)
    assert torch.equal(pc["kv"]["pos"], jc["kv/pos"])
    for k in ("k", "v"):
        want, got = jc[f"kv/{k}"], pc["kv"][k]
        if cache_dtype == "float32":
            _close(got, want, F32_TOL)
        else:                        # f32 k, v rounded once to bf16
            _within(got, want)


def test_prefill_matches_jax_bf16_with_pallas_core(monkeypatch):
    (_, _, jl, jc), (_, pl, pc) = _both_prefill("bfloat16", monkeypatch)
    _close(pl, _torch(jl, torch.bfloat16), BF16_TOL)
    assert torch.equal(pc["kv"]["pos"], jc["kv/pos"])
    for k in ("k", "v"):
        _close(pc["kv"][k], jc[f"kv/{k}"], BF16_TOL)


def _decode_both(jm, params, pm, jcaches, pcaches, toks, positions, tol):
    """Decode at `positions` in both, each side from its own caches: the
    inputs are the columns of `toks` (B, n) for the first n steps, then
    JAX's greedy tokens."""
    jdec = jax.jit(jm.decode_step)
    for i, pos in enumerate(positions):
        tok = toks[:, i:i + 1] if i < toks.shape[1] else \
            want.float().argmax(-1)[:, None].numpy()
        jlog, jcaches = jdec(params, jcaches, jnp.asarray(tok, jnp.int32),
                             pos)
        plog, pcaches = pm.decode_step(pcaches, torch.from_numpy(
            np.asarray(tok)).long(), pos)
        want = _torch(jlog, plog.dtype)
        _close(plog, want, tol)
        jc = params_from_jax(jax.tree.map(np.asarray, jcaches))
        assert torch.equal(pcaches["kv"]["pos"], jc["kv/pos"]), pos
        for k in ("k", "v"):
            _close(pcaches["kv"][k], jc[f"kv/{k}"], tol)
        top2 = want.float().topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol * want.abs().max().item()
        assert torch.equal(plog.argmax(-1)[sure], want.argmax(-1)[sure])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_after_prefill_matches_jax(dtype, monkeypatch):
    """4 greedy steps at positions S..S+3 from the prefill's caches, whose
    length is the prompt's: each writes ring slot pos % S, evicting
    positions 0..3 on every layer, as JAX does."""
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    (jm, params, jl, jc), (pm, _, pc) = _both_prefill(dtype, monkeypatch)
    first = np.asarray(jl.astype(jnp.float32)).argmax(-1)[:, None]
    _decode_both(jm, params, pm, jax.tree.map(jnp.asarray, params_to_jax(jc)),
                 pc, first, range(S, S + 4), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_from_fresh_caches_matches_jax(dtype):
    """The prompt decoded token by token into empty rings of 8 slots:
    positions 8..11 wrap the ring."""
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg = dataclasses.replace(JAX_ARCH.smoke, dtype=dtype)
    pcfg = dataclasses.replace(SPEC.smoke, dtype=dtype)
    params, toks = _params(jcfg), _prompts(jcfg)
    jm = JaxModel(jcfg)
    pm = Model(pcfg, device="cpu")
    pm.load_params(params_from_jax(params))
    _decode_both(jm, params, pm, jm.init_caches(B, 8), pm.init_caches(B, 8),
                 toks, range(12), tol)


@pytest.mark.parametrize("cache_len", [4, 20])
def test_init_caches_match_jax(cache_len):
    want = params_from_jax(jax.tree.map(
        np.asarray, JaxModel(JAX_ARCH.smoke).init_caches(3, cache_len)))
    pm = Model(SPEC.smoke, device="cpu")
    got = pm.init_caches(3, cache_len)["kv"]
    for k in ("k", "v", "pos"):
        assert got[k].dtype == want[f"kv/{k}"].dtype
        assert torch.equal(got[k], want[f"kv/{k}"]), k


@pytest.mark.parametrize("kind,seq_len,batch", [
    ("decode", SMOKE_DECODE.seq_len, SMOKE_DECODE.global_batch),
    ("prefill", 8192, 4), ("decode", LONG_SEQ, 1)])
def test_serve_setup_matches_jax(kind, seq_len, batch):
    """The cache_len rule (window-capped rings from LONG_SEQ on), batch and
    sequence length equal JAX's `build_serve_setup` on a one-device mesh;
    the prefill and decode shapes of gemma2's spec equal JAX's."""
    mesh = make_mesh((1, 1), ("data", "model"))
    want = jax_serve_setup(JAX_ARCH, mesh, JaxShape(kind, seq_len, batch),
                           smoke=True)
    got = build_serve_setup(SPEC, ShapeCfg(kind, seq_len, batch),
                            smoke=True, device="cpu")
    assert (got.cache_len, got.batch, got.seq_len) == \
        (want.cache_len, want.batch, want.seq_len)
    for name in ("prefill_32k", "decode_32k"):
        assert dataclasses.asdict(SPEC.shapes[name]) == \
            dataclasses.asdict(JAX_ARCH.shapes[name])


def test_convert_carries_bf16_caches_exactly():
    """JAX's bf16 caches cross into torch and back with every bit."""
    cfg = JAX_ARCH.smoke
    _, caches = jax.jit(JaxModel(cfg).prefill)(_params(cfg),
                                               jnp.asarray(_prompts(cfg)))
    tree = jax.tree.map(np.asarray, caches)
    state = params_from_jax(tree)
    assert state["kv/k"].dtype == torch.bfloat16
    assert torch.equal(state["kv/k"].view(torch.int16), torch.from_numpy(
        tree["kv"]["k"].view(np.int16).copy()))
    back = params_to_jax(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int16 if a.itemsize == 2
                                             else np.int32),
                                      b.view(np.int16 if b.itemsize == 2
                                             else np.int32))


def test_serve_parity_cpu_against_itself():
    """`serve_parity` on the CPU against itself: every gap is 0, and the
    plain versions count no kernel launch."""
    before = dict(launches)
    gaps = serve_parity("cpu")
    assert gaps and all(g == 0.0 for g in gaps.values()), gaps
    assert launches == before


def test_serve_steps_run_in_inference_mode():
    setup = build_serve_setup(SPEC, ShapeCfg("prefill", 16, 2), smoke=True,
                              device="cpu")
    setup.model.init_(0)
    logits, caches = setup.prefill_step(torch.zeros((2, 16),
                                                    dtype=torch.long))
    assert logits.shape == (2, SPEC.smoke.vocab_size)
    assert logits.is_inference() and caches["kv"]["k"].is_inference()
    assert caches["kv"]["k"].shape == (SPEC.smoke.num_layers, 2,
                                       SPEC.smoke.num_kv_heads, 16,
                                       SPEC.smoke.head_dim)
    logits2, caches2 = setup.decode_step(caches, logits.argmax(-1)[:, None],
                                         16)
    assert caches2 is caches and bool(torch.isfinite(logits2.float()).all())
    assert caches["kv"]["pos"][:, 0].tolist() == [16] * SPEC.smoke.num_layers


def test_serve_model_has_no_gradient_buffer():
    """Serving allocates no gradient buffer; a training Model keeps one,
    attached as the parameters' .grad views."""
    setup = build_serve_setup(SPEC, ShapeCfg("prefill", 16, 2), smoke=True,
                              device="cpu")
    assert setup.model.grad is None
    assert all(p.grad is None for p in setup.model.net.parameters())
    with pytest.raises(ValueError, match="with_grad=False"):
        setup.model.grads()
    train = Model(SPEC.smoke, device="cpu")
    assert train.grad.shape == train.theta.shape
    assert train.net.tok.grad.data_ptr() == \
        train.grads()["embed/tok"].data_ptr()
