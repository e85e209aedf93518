"""The port's Mamba2 block (`repro_torch.nn.ssm`) and zamba2-2.7b's hybrid
stack against the JAX package (`repro.nn.ssm`, `repro.nn.transformer`'s
hybrid family) on the CPU, on one torch thread.

  - module level, each output and the gradient of every input under a
    seeded random cotangent (`jax.vjp`), f32 rtol 1e-5 / atol 1e-6, bf16
    within 5% of the largest magnitude (tests/test_torch_model.py's
    tolerances): `causal_conv`; `ssd_chunked` at S 32 in 4 chunks of 8, so
    the cross-chunk carries run (the port folds them in order where JAX's
    `associative_scan` combines a tree: f32 tolerance, not bits); and
    `apply_mamba2` at chunk 8 on JAX's init with A_log, D and dt_bias
    drawn off their constants;
  - the stack (smoke config: 4 layers in 2 groups of 2 and the shared
    attention block after each): spec, leaf names, shapes and order,
    theta0 bit for bit, loss and every gradient leaf in f32 and bf16, an
    RPR1 checkpoint both ways and `convert`'s round trip;
  - the slice: 3 steps on the sign wire against JAX's real (data=4,
    model=1) mesh step (`_torch_cases.JAX_RUN`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_cases import _jax_run, one_thread
from repro.configs import REGISTRY as JREG
from repro.nn import ssm as JSSM
from repro_torch.configs import REGISTRY
from repro_torch.nn import ssm as SSM
from test_torch_families import (check_checkpoint_and_convert,
                                 check_loss_and_grads, check_mesh_end_to_end,
                                 check_mesh_setup, check_mesh_stage2,
                                 check_module, check_param_tree_and_theta0,
                                 check_specs, _setup)

ARCH = "zamba2-2.7b"
MESH = {"arch": ARCH}                 # the sign wire
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _normal(rng, shape, scale=1.0, dtype=jnp.float32):
    return jnp.asarray(rng.standard_normal(shape) * scale,
                       jnp.float32).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    ct = jnp.dtype(dtype)
    u, w, b = (_normal(rng, (2, 16, 12), 1.0, ct),
               _normal(rng, (4, 12), 0.5, ct), _normal(rng, (12,), 0.1, ct))
    check_module(lambda u, w, b: JSSM._causal_conv(u, w, b)[0],
                 SSM.causal_conv, (u, w, b), dtype)


def test_ssd_chunked_matches_jax_over_four_chunks():
    """S 32 in chunks of 8: y, the final state and every input's gradient,
    f32."""
    rng = np.random.default_rng(1)
    b, S, H, hd, N = 2, 32, 3, 8, 5
    x = _normal(rng, (b, S, H, hd))
    dt = jnp.asarray(rng.uniform(0.05, 0.6, (b, S, H)), jnp.float32)
    A = -jnp.asarray(rng.uniform(0.3, 2.0, (H,)), jnp.float32)
    B, C = _normal(rng, (b, S, N)), _normal(rng, (b, S, N))
    check_module(lambda *a: JSSM._ssd_chunked(*a, chunk=8),
                 lambda *a: SSM.ssd_chunked(*a, chunk=8),
                 (x, dt, A, B, C), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mamba2_matches_jax(dtype):
    """The block on the smoke config's shapes at S 32, chunk 8 (4 chunks),
    from JAX's init_mamba2 with A_log, D and dt_bias drawn."""
    cfg = REGISTRY[ARCH].smoke.scaled(dtype=dtype)
    jcfg = JREG[ARCH].smoke.scaled(dtype=dtype)
    p = jax.jit(lambda k: JSSM.init_mamba2(k, jcfg))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    H = jcfg.ssm_heads
    p = dict(p, A_log=_normal(rng, (H,), 0.5), D=_normal(rng, (H,), 1.0),
             dt_bias=_normal(rng, (H,), 0.5),
             conv_b_x=_normal(rng, (jcfg.d_inner,), 0.1))
    x = _normal(rng, (2, 32, jcfg.d_model), 1.0, jnp.dtype(dtype))
    check_module(lambda p, x: JSSM.apply_mamba2(p, x, jcfg, chunk=8)[0],
                 lambda p, x: SSM.apply_mamba2(p, x, cfg, chunk=8),
                 (p, x), dtype)


def test_spec_matches_jax():
    check_specs(ARCH)


def test_param_tree_and_theta0_equal_jax():
    """blocks (G 2, period 2, ...) of Mamba2, then shared_attn after
    final_norm in JAX's order; theta0 bit for bit."""
    check_param_tree_and_theta0(ARCH)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_jax(dtype, monkeypatch):
    """The shared block's gradient sums its uses after both groups."""
    check_loss_and_grads(ARCH, dtype, monkeypatch, bf16_ref32=True)


def test_checkpoint_and_convert_carry_the_tree(tmp_path):
    check_checkpoint_and_convert(tmp_path, ARCH)


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """JAX's dump of 3 mesh steps of zamba2's smoke config, sign wire."""
    return _jax_run(tmp_path_factory, MESH)


def test_mesh_setup_batches_and_masks_equal_jax(mesh_ref):
    check_mesh_setup(_setup(ARCH, MESH), mesh_ref)


def test_mesh_stage2_with_jax_gradients(mesh_ref):
    check_mesh_stage2(ARCH, mesh_ref, MESH)


def test_mesh_end_to_end_matches_jax(mesh_ref):
    check_mesh_end_to_end(ARCH, mesh_ref, MESH)


def test_step_parity_cpu_against_cpu():
    """The card-against-CPU check of chip_smoke.py and the gpu tests, CPU
    on both sides, on the smoke config (sign wire): stage 2 bit for
    bit."""
    from repro_torch.launch.device_parity import step_parity
    out = step_parity("cpu", arch=ARCH, compressor="sign")
    assert out["max_abs_dtheta"] == 0.0 and \
        out["loss_cpu"] == out["loss_device"]
