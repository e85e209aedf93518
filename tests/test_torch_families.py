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
  - the chip cells' parameter counts (olmoe at depth 6 of 16, musicgen
    at full depth) without allocating;
  - the driver's default arch is olmoe-1b-7b, and its run resumes bit for
    bit; an embeddings arch through the driver, elastic and prefetched,
    trains the synchronous run's bits.
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


def _jax_params(cfg):
    return jax.jit(JModel(cfg).init)(jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ("gemma2-2b",) + NEW)
def test_specs_match_the_jax_package(arch):
    got, want = REGISTRY[arch], JREG[arch]
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert dataclasses.asdict(got.smoke) == dataclasses.asdict(want.smoke)
    assert dataclasses.asdict(got.coding) == dataclasses.asdict(want.coding)
    assert {k: dataclasses.asdict(v) for k, v in got.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.shapes.items()}
    assert got.skip_shapes == want.skip_shapes and got.notes == want.notes


@pytest.mark.parametrize("arch", NEW)
def test_param_tree_and_theta0_equal_jax(arch):
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
    `fill` adds it), and the port's `top_k` returns them.  Returns
    `fill`."""
    assert cfg.moe_shared == 0
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
        return parts["out"].reshape(B, S, d), aux

    monkeypatch.setattr(JMOE, "apply_moe", jax_apply)
    jax.jit(lambda p: JModel(cfg).loss(p, batch))(params)
    jax.effects_barrier()
    ids = np.stack(rec)
    assert ids.shape[0] == cfg.num_layers

    def fill(p):
        moe = dict(p["blocks"]["moe"], fixed_idx=jnp.asarray(ids))
        return dict(p, blocks=dict(p["blocks"], moe=moe))

    by_layer = {id(pm.net._blocks[l]["moe"]): torch.from_numpy(ids[l]).long()
                for l in range(cfg.num_layers)}
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
    jcfg = dataclasses.replace(JREG[arch].smoke, dtype=dtype)
    pcfg = dataclasses.replace(REGISTRY[arch].smoke, dtype=dtype)
    params = _jax_params(jcfg)
    jbatch, pargs = _batch(jcfg)
    pm = Model(pcfg, chunk_ranks=4, group_size=32, device="cpu")
    pm.init_(0)
    fill = (_feed_jax_routing(monkeypatch, jcfg, params, jbatch, pm)
            if jcfg.family == "moe" and dtype == "bfloat16" else None)
    jl, jg = _jax_grads(jcfg, params, jbatch, fill)
    pl, _ = pm.loss(*pargs)
    pl.backward()
    pg = {k: v.numpy() for k, v in pm.grads().items()}
    assert set(pg) == set(jg)
    if dtype == "float32":
        np.testing.assert_allclose(pl.item(), jl, rtol=1e-5)
        for k in jg:
            np.testing.assert_allclose(pg[k], jg[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        return
    np.testing.assert_allclose(pl.item(), jl, rtol=1e-2)
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
    """olmoe-1b-7b at full width and depth 6 of 16 and musicgen-large at
    full width and depth (the card's cells), and full-depth olmoe against
    JAX's count (shapes only, nothing allocated)."""
    olmoe = REGISTRY["olmoe-1b-7b"].config
    assert num_params(olmoe) == JModel(JREG["olmoe-1b-7b"].config
                                       ).num_params() == 6_919_096_320
    assert num_params(dataclasses.replace(olmoe, num_layers=6)) == \
        2_723_440_640
    assert num_params(REGISTRY["musicgen-large"].config) == \
        JModel(JREG["musicgen-large"].config).num_params() == 2_424_705_024


@pytest.fixture(scope="module", params=list(MESH_RUNS))
def mesh_run(request, tmp_path_factory):
    """(arch, JAX's dump of 3 mesh steps) for olmoe (sign) and musicgen
    (block top-K)."""
    return request.param, _jax_run(tmp_path_factory,
                                   MESH_RUNS[request.param])


def _setup(arch):
    kw = {k: v for k, v in MESH_RUNS[arch].items() if k != "arch"}
    return _port_setup(arch=arch, **kw)


def test_mesh_setup_batches_and_masks_equal_jax(mesh_run):
    """Flat size, encode weights, theta0 (the port's own init), masks and
    every batch tensor (for musicgen the bf16 embeddings) exactly
    JAX's."""
    arch, ref = mesh_run
    s = _setup(arch)
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
    if arch == "olmoe-1b-7b":
        sign_stage2_checks(ref)
    else:
        block_stage2_checks(ref, _setup(arch))


def test_mesh_end_to_end_matches_jax(mesh_run):
    """The port's whole step from JAX's params, batches and masks, 3 steps:
    loss rtol 1e-4 and theta within the wire's flip bound."""
    arch, ref = mesh_run
    s = _setup(arch)
    end_to_end_checks(ref, s, 2 * N if arch == "olmoe-1b-7b" else N)
    if arch == "olmoe-1b-7b":
        m = s.train_step(s.model, torch.zeros((N, s.flat_pad)),
                         jax_batch(ref, 0), 0)
        assert m["moe_dropped"].tolist() == [0] * N     # capacity 4.0


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


def test_serving_refuses_the_new_families():
    """Prefill and decode of every new arch (the MoE family, the embeddings
    input, LayerNorm, qkv bias, the other MLPs, the untied head) are
    ROADMAP A9: only gemma2's stack is served."""
    for arch in NEW:
        m = Model(REGISTRY[arch].smoke, device="cpu", with_grad=False)
        with pytest.raises(NotImplementedError, match="A9"):
            m.prefill(torch.zeros((1, 4), dtype=torch.long))
        with pytest.raises(NotImplementedError, match="A9"):
            m.decode_step({}, torch.zeros((1, 1), dtype=torch.long), 0)


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
