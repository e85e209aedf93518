"""The port's gemma2-2b stack against the JAX package on the smoke config,
with the same weights (carried over by `repro_torch.convert`).

Tolerances: in float32, loss and every gradient leaf within rtol 1e-5,
atol 1e-6 (the CPU sums in another order in each framework).  In the
default bf16 compute dtype the two frameworks round at other places (bf16
matmul outputs, tanh, softmax), so the loss is held to 1e-2 relative and
each gradient leaf to 5% of its largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.gemma2_2b import ARCH as JAX_ARCH
from repro.core.cocoef import flatten_local
from repro.nn import Model as JaxModel
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.nn.models import Model
from repro_torch.nn.transformer import num_params, param_shapes

SPEC = REGISTRY["gemma2-2b"]


def _key_name(path) -> str:
    return "/".join(k.key for k in path)


def _jax_params(cfg):
    return jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0)))


def _batch(cfg, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, B).astype(np.float32)
    return toks, w


def _both(dtype: str):
    jcfg = dataclasses.replace(JAX_ARCH.smoke, dtype=dtype)
    pcfg = dataclasses.replace(SPEC.smoke, dtype=dtype)
    params = _jax_params(jcfg)
    toks, w = _batch(jcfg)
    jm = JaxModel(jcfg)
    batch = {"inputs": jnp.asarray(toks), "weights": jnp.asarray(w)}
    (jloss, jper), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(params)
    pm = Model(pcfg, chunk_ranks=4, group_size=32, device="cpu")
    pm.load_params(params_from_jax(params))
    ploss, pper = pm.loss(torch.from_numpy(toks).long(), torch.from_numpy(w))
    ploss.backward()
    jg = {_key_name(p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    pg = {k: v.numpy() for k, v in pm.grads().items()}
    return (float(jloss), np.asarray(jper), jg), \
        (ploss.item(), pper.detach().numpy(), pg)


def test_configs_match_the_jax_package():
    assert dataclasses.asdict(SPEC.config) == \
        dataclasses.asdict(JAX_ARCH.config)
    assert dataclasses.asdict(SPEC.smoke) == dataclasses.asdict(JAX_ARCH.smoke)
    for f in ("redundancy", "straggler_p", "group_size", "compressor",
              "coding_axes", "k_per_block", "block_size", "topk_k",
              "wire_dtype"):
        assert getattr(SPEC.coding, f) == getattr(JAX_ARCH.coding, f)


def test_full_size_shapes_and_count_without_allocating():
    """Shapes only: JAX's eval_shape against the port's shape table."""
    jshapes = JaxModel(JAX_ARCH.config).param_shapes()
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    want = {_key_name(p): tuple(v.shape) for p, v in flat}
    assert param_shapes(SPEC.config) == want
    assert num_params(SPEC.config) == 2_660_228_352
    from repro_torch.core.cocoef import flat_layout
    lay = flat_layout(param_shapes(SPEC.config), 4, 512)
    assert list(lay.names) == [_key_name(p) for p, _ in flat]
    assert lay.padded == 2_660_229_120


def test_convert_round_trip_is_identity():
    params = _jax_params(JAX_ARCH.smoke)
    back = params_to_jax(params_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_flat_layout_equals_jax_flatten_local():
    params = _jax_params(JAX_ARCH.smoke)
    want, meta = flatten_local(jax.tree.leaves(params), 4, 32)
    pm = Model(SPEC.smoke, chunk_ranks=4, group_size=32, device="cpu")
    pm.load_params(params_from_jax(params))
    assert pm.layout.padded == meta.padded == 164_480
    np.testing.assert_array_equal(pm.theta.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_loss_and_grads_match_jax_f32():
    (jl, jper, jg), (pl, pper, pg) = _both("float32")
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pper, jper, rtol=1e-5)
    assert set(pg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_loss_and_grads_match_jax_bf16():
    (jl, jper, jg), (pl, pper, pg) = _both("bfloat16")
    np.testing.assert_allclose(pl, jl, rtol=1e-2)
    for k in jg:
        scale = np.abs(jg[k]).max()
        assert np.abs(pg[k] - jg[k]).max() <= 0.05 * scale, k


def test_grads_accumulate_into_the_flat_buffer_in_place():
    """Autograd writes every leaf's gradient into the one flat buffer (no
    per-leaf copies), and the padding tail stays zero."""
    pm = Model(SPEC.smoke, chunk_ranks=4, group_size=32, device="cpu")
    pm.init_(0)
    ptr = pm.grad.data_ptr()
    toks, w = _batch(SPEC.smoke, B=2, S=16)
    loss, _ = pm.loss(torch.from_numpy(toks).long(), torch.from_numpy(w))
    loss.backward()
    assert pm.grad.data_ptr() == ptr
    for blk in pm.net.layers:
        for p in blk.values():
            assert p.grad.untyped_storage().data_ptr() == \
                pm.grad.untyped_storage().data_ptr()
    assert pm.grad[pm.layout.total:].abs().max() == 0
    assert pm.grad[:pm.layout.total].abs().max() > 0
