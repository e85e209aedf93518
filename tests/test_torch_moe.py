"""The port's MoE layer (`repro_torch/nn/moe.py`) against JAX's
`repro.nn.moe` on olmoe-1b-7b's smoke config (8 experts, top 2), in f32
and bf16, with capacity factor 4.0 (nothing dropped) and 0.5 (about half
the assignments dropped), without and with a shared expert.

  - routing: fed JAX's own router probabilities, the port's gate ids, its
    sorted order, slots, keep flags and kept counts equal JAX's exactly
    (so exactness does not hang on the router matmul's summation order);
  - combine: fed JAX's expert outputs and those probabilities, the port's
    combine equals JAX's scatter-add bit for bit (ascending expert id,
    every add rounded to the compute dtype);
  - the whole layer from the same weights and input, the port's own router
    included: out, aux and every gradient against `jax.grad` in f32
    within rtol 1e-5 / atol 1e-6 (tests/test_torch_model.py's f32
    tolerance; the matmuls sum in other orders), the atol taken relative
    to each tensor's largest magnitude: the cotangent here is O(1) at
    every output, so the router's gradient sums terms up to 20 that
    cancel to entries below 1;
  - two forward and backward passes give the same bits (no atomics decide
    a float; tests/test_torch_gpu.py repeats this on the card, where it
    also checks that the layer never synchronises the host).

JAX's intermediates come from a copy of its `apply_moe` steps run under
`jax.jit`, held bit for bit against the real `apply_moe` first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import one_thread
from repro.configs import REGISTRY as JREG
from repro.nn import moe as JMOE
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_jax
from repro_torch.nn import moe as MOE

B, S = 4, 32
CASES = [(dt, cf, sh) for dt in ("float32", "bfloat16")
         for cf in (4.0, 0.5) for sh in (0, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module on one torch thread (`_torch_cases.one_thread`)."""
    with one_thread():
        yield


def _cfg(pkg_registry, dtype, cf, shared):
    return dataclasses.replace(pkg_registry["olmoe-1b-7b"].smoke, dtype=dtype,
                               capacity_factor=cf, moe_shared=shared)


def _jax_parts(p, x, cfg, gate_idx=None):
    """JAX's `apply_moe`, step by step (repro/nn/moe.py), returning its
    intermediates; `out` is the routed part before the shared experts.
    Given `gate_idx` (T, k), the tokens go to those experts (their gates
    read off the probs) in place of the top k."""
    ct = x.dtype
    T, d = x.shape[0] * x.shape[1], x.shape[2]
    E, k = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(T, d)
    logits = xt.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    if gate_idx is None:
        gate_vals, gate_idx = jax.lax.top_k(probs, k)
    else:
        gate_vals = jnp.take_along_axis(probs, gate_idx, axis=1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdims=True) + 1e-9)
    C = JMOE.capacity(T, cfg)
    eflat = gate_idx.reshape(-1)
    order = jnp.argsort(eflat, stable=True)
    sorted_e = eflat[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    pos = jnp.arange(T * k) - starts[sorted_e]
    keep = pos < C
    slot = jnp.where(keep, sorted_e * C + pos, E * C)
    token_of = order // k
    xe = jnp.zeros((E * C, d), ct).at[slot].set(
        xt[token_of], mode="drop").reshape(E, C, d)
    h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", xe, p["w_gate"].astype(ct)))
    h = h * jnp.einsum("ecd,edf->ecf", xe, p["w_up"].astype(ct))
    ye = jnp.einsum("ecf,efd->ecd", h, p["w_down"].astype(ct))
    y_slots = ye.reshape(E * C, d)[jnp.minimum(slot, E * C - 1)]
    gv = (gate_vals.reshape(-1)[order] * keep).astype(ct)
    out = jnp.zeros((T, d), ct).at[token_of].add(y_slots * gv[:, None])
    counts = jnp.bincount(jnp.where(keep, sorted_e, E), length=E + 1)[:E]
    return dict(probs=probs, gate_idx=gate_idx, order=order, slot=slot,
                keep=keep, counts=counts, ye=ye, out=out)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _inputs(dtype, cf, shared, seed=0):
    jcfg, pcfg = (_cfg(JREG, dtype, cf, shared),
                  _cfg(REGISTRY, dtype, cf, shared))
    jp = jax.jit(lambda k: JMOE.init_moe(k, jcfg))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((B, S, jcfg.d_model)),
                    jnp.float32).astype(jnp.dtype(dtype))
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    ptree = {k: v for k, v in pp.items() if "/" not in k}
    if shared:
        ptree["shared"] = {k.split("/")[1]: v for k, v in pp.items()
                           if k.startswith("shared/")}
    return jcfg, pcfg, jp, x, ptree


@pytest.mark.parametrize("dtype,cf,shared", CASES)
def test_routing_exact_and_combine_bit_equal(dtype, cf, shared):
    jcfg, pcfg, jp, x, pp = _inputs(dtype, cf, shared)
    parts = jax.jit(lambda p, x: _jax_parts(p, x, jcfg))(jp, x)
    # the copy is JAX's layer: its routed output (+ the shared experts)
    # and aux equal the real apply_moe's bit for bit
    jout, jaux = jax.jit(lambda p, x: JMOE.apply_moe(p, x, jcfg))(jp, x)
    routed = parts["out"]
    if shared:
        sp = jp["shared"]
        xt = x.reshape(-1, x.shape[-1])
        ct = x.dtype
        hs = jax.nn.silu(xt @ sp["w_gate"].astype(ct)) * \
            (xt @ sp["w_up"].astype(ct))
        routed = routed + hs @ sp["w_down"].astype(ct)
    routed = jax.jit(lambda a: a)(routed)
    if not shared:
        np.testing.assert_array_equal(
            np.asarray(routed).reshape(B, S, -1).view(np.uint8),
            np.asarray(jout).view(np.uint8))
    T, k = B * S, jcfg.moe_top_k
    C = JMOE.capacity(T, jcfg)
    assert MOE.capacity(T, pcfg) == C
    probs = _to_torch(parts["probs"])
    gate_vals, r = MOE.route(probs, MOE.top_k(probs, k), pcfg, C)
    np.testing.assert_array_equal(
        r.order.numpy(), np.asarray(parts["order"]))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(parts["slot"]))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(parts["keep"]))
    np.testing.assert_array_equal(r.counts.numpy(),
                                  np.asarray(parts["counts"]))
    np.testing.assert_array_equal(r.gate_idx.numpy(),
                                  np.asarray(parts["gate_idx"]))
    kept = int(np.asarray(parts["keep"]).sum())
    assert int(r.dropped) == T * k - kept
    if cf < 1:
        assert T * k - kept > T * k // 4          # real drops
    else:
        assert kept == T * k
    got = MOE.combine(_to_torch(parts["ye"]), gate_vals, r)
    want = np.asarray(parts["out"])
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(got), want.view(
        np.int16 if dtype == "bfloat16" else np.int32))


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).numpy()


def test_top_k_equals_lax_top_k():
    """`top_k` gives lax.top_k's ids, in its order, on random softmax
    probs of every size the smoke and full configs route over."""
    rng = np.random.default_rng(5)
    for E, k in ((8, 2), (64, 8), (160, 6)):
        logits = rng.standard_normal((B * S, E)).astype(np.float32)
        probs = torch.softmax(torch.from_numpy(logits), -1)
        want = jax.lax.top_k(jnp.asarray(probs.numpy()), k)[1]
        np.testing.assert_array_equal(MOE.top_k(probs, k).numpy(),
                                      np.asarray(want))


def test_gate_ids_follow_lax_top_k_ties():
    """Equal probabilities pick the lower expert ids first, as lax.top_k
    (torch.topk need not: ROADMAP C1)."""
    cfg = _cfg(REGISTRY, "float32", 4.0, 0)
    probs = torch.full((3, cfg.moe_experts), 1.0 / cfg.moe_experts)
    probs[1, 6] = probs[1, 5] = 0.3
    probs[2, 3] = 0.2
    _, r = MOE.route(probs, MOE.top_k(probs, 2), cfg, 8)
    jidx = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1])
    assert jidx.tolist() == [[0, 1], [5, 6], [3, 0]]
    np.testing.assert_array_equal(r.gate_idx.numpy(), jidx)


def _jax_value_and_grads(jp, x, jcfg, cot):
    def f(p, x):
        out, aux = JMOE.apply_moe(p, x, jcfg)
        return jnp.sum(out.astype(jnp.float32) * cot) + aux, (out, aux)
    (val, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, x)
    return out, aux, gp, gx


def _port_value_and_grads(pp, x, pcfg, cot):
    leaves = {}

    def leaf(v):
        return v.clone().requires_grad_(True)
    p = {k: (leaf(v) if not isinstance(v, dict)
             else {kk: leaf(vv) for kk, vv in v.items()})
         for k, v in pp.items()}
    xt = x.clone().requires_grad_(True)
    out, aux, dropped = MOE.apply_moe(p, xt, pcfg)
    (torch.sum(out.float() * cot) + aux).backward()
    for k, v in p.items():
        if isinstance(v, dict):
            leaves.update({f"{k}/{kk}": vv.grad for kk, vv in v.items()})
        else:
            leaves[k] = v.grad
    return out, aux, dropped, leaves, xt.grad


@pytest.mark.parametrize("cf,shared", [(4.0, 0), (0.5, 0), (0.5, 1)])
def test_layer_and_gradients_match_jax_f32(cf, shared):
    jcfg, pcfg, jp, x, pp = _inputs("float32", cf, shared, seed=1)
    cot = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jout, jaux, jgp, jgx = _jax_value_and_grads(jp, x, jcfg, cot)
    out, aux, _, gp, gx = _port_value_and_grads(pp, _to_torch(x), pcfg,
                                                torch.from_numpy(cot))
    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=what)
    close(out.detach().numpy(), jout, "out")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    close(gx.numpy(), jgx, "x")
    flat = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jgp)[0]}
    assert set(flat) == set(gp)
    for k, v in flat.items():
        close(gp[k].numpy(), v, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_repeat_check_runs_on_the_cpu(dtype):
    """`device_parity.moe_repeat`, which chip_smoke.py and the gpu tests
    run on the card, passes on the CPU."""
    from repro_torch.launch.device_parity import moe_repeat
    assert moe_repeat("cpu", dtype)["dropped"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_backward_repeat_bit_for_bit(dtype):
    _, pcfg, _, x, pp = _inputs(dtype, 0.5, 1, seed=3)
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S, pcfg.d_model)).astype(np.float32))
    runs = [_port_value_and_grads(pp, _to_torch(x), pcfg, cot)
            for _ in range(2)]
    (o0, a0, d0, g0, x0), (o1, a1, d1, g1, x1) = runs
    assert np.array_equal(_bits(o0), _bits(o1))
    assert a0.item() == a1.item() and int(d0) == int(d1) > 0
    assert np.array_equal(_bits(x0), _bits(x1))
    for k in g0:
        assert np.array_equal(_bits(g0[k]), _bits(g1[k])), k
