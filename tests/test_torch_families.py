"""The port's dense variants and MoE family against the JAX package, on the
smoke configs of phi3-medium-14b (swiglu, untied head), nemotron-4-15b
(relu2, LayerNorm), qwen1.5-110b (qkv bias), llava-next-34b and
musicgen-large (the embeddings input; musicgen also gelu and LayerNorm)
and olmoe-1b-7b (64 experts of top 8 at full size; 8 of top 2 here).

  - specs: config, smoke config, coding plan, shapes and notes equal
    JAX's `repro.configs`;
  - the param tree: leaf names, shapes and order equal JAX's
    `tree_flatten_with_path`, and theta0 from `Model.init_(0)` equals
    `jax.jit(init_params)(PRNGKey(0))` bit for bit;
  - loss and every gradient leaf against JAX's `weighted_loss` from the
    same weights and batch: f32 rtol 1e-5 / atol 1e-6; bf16 loss rtol
    1e-2 and each leaf within 5% of its largest magnitude
    (tests/test_torch_model.py's tolerances).  olmoe in bf16 runs with
    JAX's routing fed in on both sides (each layer's gate ids from JAX's
    own bf16 forward): the smoke router's probabilities are near uniform,
    so a hidden state one bf16 rounding away picks another expert for
    some tokens, and JAX's own bf16 gradients differ from its f32 ones by
    20 to 40% of a leaf through those flips alone;
  - the embeddings batch (JAX's normal(PRNGKey(0), ., bf16) * 0.02 and
    the coded tokens' first L as targets) bit for bit;
  - the port's step against JAX's real (data=4, model=1) mesh step for
    olmoe on the sign wire and musicgen on block top-K, 3 steps (one JAX
    subprocess each, `_torch_cases.JAX_RUN`): setup, batches and masks
    exact; stage 2 on JAX's gradients and the end-to-end bounds of
    tests/test_torch_train.py;
  - card-against-CPU parity run CPU against CPU for each new arch (stage 2
    bit for bit, `launch/device_parity.py`);
  - the chip cells' parameter counts (olmoe at depth 6 of 16, musicgen,
    zamba2 and xlstm at full depth, deepseek at depth 5 of 27) without
    allocating (serving every arch is tests/test_torch_serve_families.py);
  - the driver's default arch is olmoe-1b-7b, and its run resumes bit for
    bit; an embeddings arch through the driver, elastic and prefetched,
    trains the synchronous run's bits.

The `check_*` helpers, `check_module` and `assert_close` are shared with
tests/test_torch_mla.py, test_torch_ssm.py and test_torch_xlstm.py (the
deepseek, zamba2 and xlstm families, one file each).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import N, _jax_run, _port_setup, jax_batch, one_thread
from repro.configs import REGISTRY as JREG
from repro.nn import Model as JModel
from repro.nn import moe as JMOE
from repro_torch.configs import REGISTRY
from repro_torch.core import prng
from repro_torch.launch.device_parity import step_parity
from repro_torch.nn import moe as MOE
from repro_torch.nn.models import Model
from repro_torch.nn.transformer import num_params
from test_torch_driver import _run
from test_torch_moe import _jax_parts
from test_torch_train import (block_stage2_checks, end_to_end_checks,
                              sign_stage2_checks)

NEW = ("phi3-medium-14b", "nemotron-4-15b", "qwen1.5-110b",
       "llava-next-34b", "musicgen-large", "olmoe-1b-7b")
MESH_RUNS = {"olmoe-1b-7b": {"arch": "olmoe-1b-7b"},
             "musicgen-large": {"arch": "musicgen-large",
                                "compressor": "block_topk"}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module on one torch thread (`_torch_cases.one_thread`)."""
    with one_thread():
        yield


def _key_name(path) -> str:
    return "/".join(k.key for k in path)


def to_torch(tree):
    """A JAX array or nested dicts, tuples and lists of them as torch
    tensors (bf16 through a 16-bit view), the same nesting."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def assert_close(got, want, dtype: str, what: str = "", want32=None
                 ) -> None:
    """A module's output or gradient against JAX's.  f32: rtol 1e-5 and
    atol 1e-6 times the larger of 1 and JAX's largest magnitude (a 1-ulp
    difference of exp, log1p or silu between XLA:CPU and torch, carried
    through a sum of unit-scale terms, lands a few ulps of the largest
    term away from an output near zero).  bf16: within 5% of JAX's largest
    magnitude (tests/test_torch_model.py), or, given JAX's f32 result
    `want32`, within twice JAX's own bf16 error against it (each
    framework rounds as often, at other places: their distance is at most
    the sum of two such errors).  Finite either way."""
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max(initial=0.0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, scale), err_msg=what)
        return
    bound = 0.05 * scale
    if want32 is not None:
        want32 = np.asarray(want32).astype(np.float32)
        bound = max(bound, 2.0 * np.abs(want - want32).max(initial=0.0))
    assert np.abs(got - want).max(initial=0.0) <= bound, what


def _jax_params(cfg):
    return jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))


def _leaves(tree) -> list:
    """Leaves of nested dicts, tuples and lists in JAX's order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def check_module(jfn, pfn, args, dtype: str, seed: int = 0) -> None:
    """A module of the JAX package against the port's: jfn(*args) under
    `jax.jit` and pfn on the same values as torch tensors (nested dicts of
    params allowed); every output leaf, and the gradient of every input
    leaf under one seeded random cotangent (`jax.vjp` against
    `torch.autograd.grad`), within `assert_close`."""
    jargs = jax.tree.map(jnp.asarray, list(args))
    rng = np.random.default_rng(seed)
    cts = jax.tree.map(lambda o: jnp.asarray(
        rng.standard_normal(o.shape), jnp.float32).astype(o.dtype),
        jax.eval_shape(jfn, *jargs))

    def f(*a):
        out, vjp = jax.vjp(jfn, *a)
        return out, vjp(jax.tree.map(lambda c, o: c.astype(o.dtype), cts,
                                     out))
    jout, jgrads = jax.jit(f)(*jargs)
    ref32 = [None] * (len(jax.tree.leaves(jout))
                      + len(jax.tree.leaves(jgrads)))
    if dtype != "float32":       # the same values in f32: JAX's f32 result
        up = jax.tree.map(lambda a: a.astype(jnp.float32), jargs)
        ref32 = jax.tree.leaves(jax.jit(f)(*up))
    targs = [to_torch(a) for a in jargs]
    inputs = _leaves(targs)
    for t in inputs:
        t.requires_grad_()
    outs = _leaves(pfn(*targs))
    want = jax.tree.leaves(jout)
    assert len(outs) == len(want)
    for i, (a, b) in enumerate(zip(outs, want)):
        assert_close(a, b, dtype, f"output {i}", ref32[i])
    grads = torch.autograd.grad(outs, inputs,
                                [to_torch(c) for c in jax.tree.leaves(cts)],
                                allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, inputs)]
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for i, (a, b) in enumerate(zip(grads, want)):
        assert_close(a, b, dtype, f"gradient of input leaf {i}",
                     ref32[len(outs) + i])


@pytest.mark.parametrize("arch", ("gemma2-2b",) + NEW)
def test_specs_match_the_jax_package(arch):
    check_specs(arch)


def check_specs(arch):
    """The port's ArchSpec of `arch` equals JAX's: config, smoke config,
    coding plan, shapes, skips and notes."""
    got, want = REGISTRY[arch], JREG[arch]
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert dataclasses.asdict(got.smoke) == dataclasses.asdict(want.smoke)
    assert dataclasses.asdict(got.coding) == dataclasses.asdict(want.coding)
    assert {k: dataclasses.asdict(v) for k, v in got.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.shapes.items()}
    assert got.skip_shapes == want.skip_shapes and got.notes == want.notes


@pytest.mark.parametrize("arch", NEW)
def test_param_tree_and_theta0_equal_jax(arch):
    check_param_tree_and_theta0(arch)


def check_param_tree_and_theta0(arch):
    """Leaf names, shapes and order of the smoke config's flat layout equal
    JAX's `tree_flatten_with_path`; `Model.init_(0)` equals
    `jax.jit(init_params)(PRNGKey(0))` bit for bit; the padding is 0."""
    cfg = REGISTRY[arch].smoke
    flat = jax.tree_util.tree_flatten_with_path(_jax_params(JREG[arch].smoke)
                                                )[0]
    m = Model(cfg, chunk_ranks=4, group_size=32, device="cpu")
    assert list(m.layout.names) == [_key_name(p) for p, _ in flat]
    assert list(m.layout.shapes) == [tuple(v.shape) for _, v in flat]
    m.init_(0)
    got = m.params()
    for p, v in flat:
        np.testing.assert_array_equal(
            got[_key_name(p)].numpy().view(np.int32),
            np.asarray(v).view(np.int32), err_msg=_key_name(p))
    assert not m.theta[m.layout.total:].any()


def _batch(cfg, seed=0, B=4, S=32):
    """(JAX's batch dict, the port's loss arguments) of one random batch."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, B).astype(np.float32)
    if cfg.input_mode == "tokens":
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        return ({"inputs": jnp.asarray(toks), "weights": jnp.asarray(w)},
                (torch.from_numpy(toks).long(), torch.from_numpy(w)))
    emb = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)) * 0.02,
                      jnp.float32).astype(jnp.bfloat16)
    tgt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pemb = torch.from_numpy(np.asarray(emb).view(np.int16).copy()).view(
        torch.bfloat16)
    return ({"inputs": emb, "targets": jnp.asarray(tgt),
             "weights": jnp.asarray(w)},
            (pemb, torch.from_numpy(w), torch.from_numpy(tgt).long()))


def _jax_grads(cfg, params, batch, fill=None):
    """JAX's (loss, gradient leaves); `fill` adds non-trainable leaves to
    the params inside the loss."""
    m = JModel(cfg)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: m.loss(fill(p) if fill else p, batch), has_aux=True))(
            params)
    return float(loss), {_key_name(p): np.asarray(v) for p, v in
                         jax.tree_util.tree_flatten_with_path(g)[0]}


def _feed_jax_routing(monkeypatch, cfg, params, batch, pm):
    """Record each MoE layer's gate ids (T, k) from JAX's own forward, then
    route both models by them: JAX's `apply_moe` becomes the step-by-step
    copy `_jax_parts` taking the ids from a `fixed_idx` leaf (the returned
    `fill` adds it), plus `apply_moe`'s shared experts where the layer has
    them, and the port's `top_k` returns them.  The MoE layers are the
    stack "blocks" (every layer in the moe family, all but block0 in
    deepseek's).  Returns `fill`."""
    rec = []

    def jax_apply(p, x, cfg):
        B, S, d = x.shape
        parts = _jax_parts(p, x, cfg, gate_idx=p.get("fixed_idx"))
        if "fixed_idx" not in p:
            jax.debug.callback(lambda a: rec.append(np.asarray(a)),
                               parts["gate_idx"], ordered=True)
        aux = cfg.moe_experts * jnp.sum(
            parts["probs"].mean(0) * parts["counts"].astype(jnp.float32)
            / (B * S))
        out = parts["out"]
        if "shared" in p:
            sp, ct, xt = p["shared"], x.dtype, x.reshape(B * S, d)
            hs = jax.nn.silu(xt @ sp["w_gate"].astype(ct)) * \
                (xt @ sp["w_up"].astype(ct))
            out = out + hs @ sp["w_down"].astype(ct)
        return out.reshape(B, S, d), aux

    monkeypatch.setattr(JMOE, "apply_moe", jax_apply)
    jax.jit(lambda p: JModel(cfg).loss(p, batch))(params)
    jax.effects_barrier()
    ids = np.stack(rec)
    assert ids.shape[0] == len(pm.net._blocks)

    def fill(p):
        moe = dict(p["blocks"]["moe"], fixed_idx=jnp.asarray(ids))
        return dict(p, blocks=dict(p["blocks"], moe=moe))

    by_layer = {id(blk["moe"]): torch.from_numpy(ids[l]).long()
                for l, blk in enumerate(pm.net._blocks)}
    port_apply, port_top_k = MOE.apply_moe, MOE.top_k

    def apply(p, x, cfg):
        idx = by_layer[id(p)]
        monkeypatch.setattr(MOE, "top_k", lambda probs, k: idx)
        try:
            return port_apply(p, x, cfg)
        finally:
            monkeypatch.setattr(MOE, "top_k", port_top_k)

    monkeypatch.setattr(MOE, "apply_moe", apply)
    return fill


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW)
def test_loss_and_grads_match_jax(arch, dtype, monkeypatch):
    check_loss_and_grads(arch, dtype, monkeypatch)


def check_loss_and_grads(arch, dtype, monkeypatch, bf16_ref32=False):
    """Loss and every gradient leaf of the smoke config against JAX's
    `weighted_loss` from the same weights and batch (the tolerances of the
    module docstring); the MoE families in bf16 on JAX's routing.  With
    `bf16_ref32` a bf16 leaf may also pass `assert_close`'s second bf16
    bound: within twice JAX's own bf16 error against its f32 gradient of
    the same weights, batch and routing."""
    jcfg = dataclasses.replace(JREG[arch].smoke, dtype=dtype)
    pcfg = dataclasses.replace(REGISTRY[arch].smoke, dtype=dtype)
    params = _jax_params(jcfg)
    jbatch, pargs = _batch(jcfg)
    pm = Model(pcfg, chunk_ranks=4, group_size=32, device="cpu")
    pm.init_(0)
    fill = (_feed_jax_routing(monkeypatch, jcfg, params, jbatch, pm)
            if jcfg.moe_experts and dtype == "bfloat16" else None)
    jl, jg = _jax_grads(jcfg, params, jbatch, fill)
    pl, _ = pm.loss(*pargs)
    pl.backward()
    pg = {k: v.numpy() for k, v in pm.grads().items()}
    assert set(pg) == set(jg)
    for k, v in pg.items():
        assert np.isfinite(v).all(), k
    if dtype == "float32":
        np.testing.assert_allclose(pl.item(), jl, rtol=1e-5)
        for k in jg:
            np.testing.assert_allclose(pg[k], jg[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        return
    np.testing.assert_allclose(pl.item(), jl, rtol=1e-2)
    if bf16_ref32:
        _, jg32 = _jax_grads(dataclasses.replace(jcfg, dtype="float32"),
                             params, jbatch, fill)
        for k in jg:
            assert_close(pg[k], jg[k], dtype, k, jg32[k])
        return
    for k in jg:
        assert np.abs(pg[k] - jg[k]).max() <= 0.05 * np.abs(jg[k]).max(), k


def test_bf16_normal_equals_jax():
    """`prng.normal_bf16` is jax.random.normal(key, shape, bf16) bit for
    bit (8 random bits a value, not the f32 draw rounded)."""
    for seed, shape in ((0, (4, 2, 16, 64)), (7, (1000,)),
                        (2 ** 31 + 5, (3, 5, 7))):
        want = jax.random.normal(jax.random.PRNGKey(seed), shape,
                                 jnp.bfloat16)
        got = prng.normal_bf16(prng.PRNGKey(seed), shape)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
        f32 = jax.random.normal(jax.random.PRNGKey(seed), shape)
        assert not np.array_equal(np.asarray(f32.astype(jnp.bfloat16)),
                                  np.asarray(want))


def test_chip_cells_parameter_counts():
    """The card's cells at full width: olmoe-1b-7b at depth 6 of 16,
    musicgen-large, zamba2-2.7b and xlstm-1.3b at full depth,
    deepseek-v2-lite-16b at depth 5 of 27; the full-depth counts against
    JAX's (shapes only, nothing allocated)."""
    olmoe = REGISTRY["olmoe-1b-7b"].config
    assert num_params(olmoe) == JModel(JREG["olmoe-1b-7b"].config
                                       ).num_params() == 6_919_096_320
    assert num_params(dataclasses.replace(olmoe, num_layers=6)) == \
        2_723_440_640
    assert num_params(REGISTRY["musicgen-large"].config) == \
        JModel(JREG["musicgen-large"].config).num_params() == 2_424_705_024
    # deepseek-v2-lite-16b at depth 5 of 27 (block0 and 4 MLA + MoE
    # blocks), zamba2-2.7b and xlstm-1.3b at full depth
    want = {"deepseek-v2-lite-16b": 15_706_484_224,
            "zamba2-2.7b": 2_422_670_240, "xlstm-1.3b": 2_019_682_640}
    for arch, n in want.items():
        assert num_params(REGISTRY[arch].config) == \
            JModel(JREG[arch].config).num_params() == n, arch
    cut = dataclasses.replace(REGISTRY["deepseek-v2-lite-16b"].config,
                              num_layers=5)
    assert num_params(cut) == JModel(dataclasses.replace(
        JREG["deepseek-v2-lite-16b"].config, num_layers=5)).num_params() \
        == 2_839_831_040


@pytest.fixture(scope="module", params=list(MESH_RUNS))
def mesh_run(request, tmp_path_factory):
    """(arch, JAX's dump of 3 mesh steps) for olmoe (sign) and musicgen
    (block top-K)."""
    return request.param, _jax_run(tmp_path_factory,
                                   MESH_RUNS[request.param])


def _setup(arch, run=None):
    """The port's smoke setup of a mesh run (`MESH_RUNS[arch]` unless
    `run` names another)."""
    kw = {k: v for k, v in (run or MESH_RUNS[arch]).items() if k != "arch"}
    return _port_setup(arch=arch, **kw)


def test_mesh_setup_batches_and_masks_equal_jax(mesh_run):
    """Flat size, encode weights, theta0 (the port's own init), masks and
    every batch tensor (for musicgen the bf16 embeddings) exactly
    JAX's."""
    arch, ref = mesh_run
    check_mesh_setup(_setup(arch), ref)


def check_mesh_setup(s, ref):
    """The checks of test_mesh_setup_batches_and_masks_equal_jax on the
    port's setup `s` of JAX's mesh run `ref`."""
    assert s.flat_pad == int(ref["flat_pad"])
    np.testing.assert_array_equal(s.W, ref["W"])
    s.init_state()
    np.testing.assert_array_equal(s.model.theta.numpy().view(np.int32),
                                  ref["theta0"].view(np.int32))
    for t in range(3):
        got = s.make_batch(t)
        want = jax_batch(ref, t)
        assert len(got) == len(want) == s.n_inputs + 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        np.testing.assert_array_equal(s.mask(t).numpy(), ref[f"mask{t}"])
    if s.n_inputs == 2:
        assert got[0].shape == (N, s.b_loc, s.seq_len,
                                s.model.cfg.d_model)


def test_mesh_stage2_with_jax_gradients(mesh_run):
    """JAX's stage-1 gradients and state into the port's stage 2: the
    checks of tests/test_torch_train.py for the run's wire."""
    arch, ref = mesh_run
    check_mesh_stage2(arch, ref, MESH_RUNS[arch])


def check_mesh_stage2(arch, ref, run):
    if run.get("compressor", "sign") == "sign":
        sign_stage2_checks(ref)
    else:
        block_stage2_checks(ref, _setup(arch, run))


def test_mesh_end_to_end_matches_jax(mesh_run):
    """The port's whole step from JAX's params, batches and masks, 3 steps:
    loss rtol 1e-4 and theta within the wire's flip bound."""
    arch, ref = mesh_run
    s = check_mesh_end_to_end(arch, ref, MESH_RUNS[arch])
    if arch == "olmoe-1b-7b":
        m = s.train_step(s.model, torch.zeros((N, s.flat_pad)),
                         jax_batch(ref, 0), 0)
        assert m["moe_dropped"].tolist() == [0] * N     # capacity 4.0


def check_mesh_end_to_end(arch, ref, run):
    """`end_to_end_checks` at the run's wire's flip bound (sign 2 N, block
    top-K N); returns the setup."""
    s = _setup(arch, run)
    end_to_end_checks(ref, s, 2 * N if run.get("compressor", "sign") ==
                      "sign" else N)
    return s


@pytest.mark.parametrize("arch", NEW)
def test_step_parity_cpu_against_cpu(arch):
    """The card-versus-CPU check of chip_smoke.py and the gpu tests, CPU
    on both sides, on each new arch (musicgen on its block top-K path)."""
    comp = "block_topk" if arch == "musicgen-large" else "sign"
    out = step_parity("cpu", arch=arch, compressor=comp)
    assert out["max_abs_dtheta"] == 0.0 and \
        out["loss_cpu"] == out["loss_device"]


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "musicgen-large"))
def test_checkpoint_and_convert_carry_the_new_trees(tmp_path, arch):
    """`checkpoint` and `convert` are generic by leaf name: the port's
    checkpoint of an olmoe or musicgen run restores in JAX (its template:
    `Model(cfg).param_shapes()`) bit for bit, and convert's round trip
    through JAX's tree is the identity."""
    check_checkpoint_and_convert(tmp_path, arch)


def check_checkpoint_and_convert(tmp_path, arch):
    """One sign step of the smoke setup, its RPR1 checkpoint restored by
    JAX's `restore_checkpoint` into its template and by the port's into a
    fresh setup, bit for bit, and `params_from_jax` / `params_to_jax`
    round trips."""
    from repro.checkpoint import checkpoint as jck
    from repro_torch import convert
    from repro_torch.checkpoint import checkpoint as ck
    s = _port_setup(arch=arch)
    e = s.init_state()
    s.train_step(s.model, e, s.make_batch(0), 0)
    ck.save_checkpoint(tmp_path, 1, {"params": s.model.params(),
                                     "e": e.view(N, 1, -1)})
    tmpl = {"params": JModel(JREG[arch].smoke).param_shapes(),
            "e": jnp.zeros((N, 1, s.flat_pad), jnp.float32)}
    step, out = jck.restore_checkpoint(tmp_path, tmpl)
    tree = jax.tree.map(np.asarray, out["params"])
    got = convert.params_from_jax(tree)
    want = s.model.params()
    assert step == 1 and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(np.asarray(out["e"]).reshape(N, -1),
                                  e.numpy())
    back = convert.params_to_jax(got)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    fresh = _port_setup(arch=arch)
    e2 = torch.zeros_like(e)
    step, _ = ck.restore_checkpoint(tmp_path, {"params": fresh.model.params(),
                                               "e": e2.view(N, 1, -1)})
    assert step == 1 and torch.equal(e2, e)
    for k, v in fresh.model.params().items():
        assert torch.equal(v, want[k]), k


def test_driver_defaults_to_olmoe_and_resumes_bit_exact(tmp_path, capsys):
    """`python -m repro_torch.launch.train_e2e --device cpu --steps 12
    --ckpt-every 10` trains olmoe-1b-7b's smoke config; a rerun with
    --steps 14 resumes from step 10 and ends on the bits of 14 straight
    steps."""
    from repro_torch.launch import train_e2e
    assert train_e2e.build_parser().parse_args([]).arch == "olmoe-1b-7b"
    first = _run(tmp_path, "ckpt", "--steps", "12", "--ckpt-every", "10",
                 arch="olmoe-1b-7b")
    assert first["setup"].model.cfg.family == "moe"
    assert "arch=olmoe-1b-7b" in capsys.readouterr().out
    resumed = _run(tmp_path, "ckpt", "--steps", "14", "--ckpt-every", "10",
                   arch="olmoe-1b-7b")
    assert "resumed from step 10" in capsys.readouterr().out
    straight = _run(tmp_path, "straight", "--steps", "14", "--ckpt-every",
                    "100", arch="olmoe-1b-7b")
    want = {r["step"]: r["loss"] for r in straight["steps"]}
    for r in first["steps"][10:] + resumed["steps"]:
        assert r["loss"] == want[r["step"]]
    assert torch.equal(resumed["e"], straight["e"])
    assert torch.equal(resumed["setup"].model.theta,
                       straight["setup"].model.theta)


def test_driver_embeddings_arch_prefetched_and_elastic(tmp_path):
    """musicgen-large through the driver with the elastic plane (its
    batch: embeddings, targets, ones, subset ids): --prefetch 2 trains
    the synchronous run's bits across re-allocations."""
    flags = ("--steps", "3", "--straggler", "markov", "--straggler-p",
             "0.25", "--elastic", "--ckpt-every", "100")
    sync = _run(tmp_path, "sync", *flags, arch="musicgen-large")
    pre = _run(tmp_path, "pre", "--prefetch", "2", *flags,
               arch="musicgen-large")
    assert sync["setup"].n_inputs == 2
    assert any(r["replan"]["reallocated"] for r in sync["steps"])
    for a, b in zip(sync["steps"], pre["steps"]):
        assert a["loss"] == b["loss"] and a["weights"] == b["weights"]
    assert torch.equal(sync["setup"].model.theta, pre["setup"].model.theta)
    assert torch.equal(sync["e"], pre["e"])
