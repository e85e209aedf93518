"""The port's xLSTM blocks (`repro_torch.nn.xlstm`) and xlstm-1.3b's stack
against the JAX package (`repro.nn.xlstm`, `repro.nn.transformer`'s xlstm
family) on the CPU, on one torch thread.

  - module level, each output and the gradient of every input under a
    seeded random cotangent (`jax.vjp`), at `test_torch_families.
    assert_close`'s tolerances (f32 rtol 1e-5 / atol 1e-6 at unit scale;
    bf16 within 5% of the largest magnitude or twice JAX's own bf16
    error): `mlstm_chunk_scan` at S 32 in 4 chunks of 8 from a drawn
    carry-in state (the carries and the stabiliser's floor run);
    `apply_mlstm` at chunk 8; the sLSTM scan (`SLSTMScan`: its forward,
    and its backward against JAX's custom_vjp and against torch autograd
    through the plain loop of `slstm_cell`; the written-out cell vjp
    against autograd of the cell in f64, ties included) and
    `apply_slstm`;
  - the stack (smoke config: 2 groups of one mLSTM and one sLSTM block):
    spec, leaf names, shapes and order, theta0 bit for bit, loss and
    every gradient leaf in f32 and bf16, an RPR1 checkpoint both ways and
    `convert`'s round trip;
  - the slice: 3 steps on block top-K against JAX's real (data=4,
    model=1) mesh step (`_torch_cases.JAX_RUN`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import _jax_run, one_thread
from repro.configs import REGISTRY as JREG
from repro.nn import xlstm as JXL
from repro_torch.configs import REGISTRY
from repro_torch.nn import xlstm as XL
from test_torch_families import (assert_close, check_checkpoint_and_convert,
                                 check_loss_and_grads, check_mesh_end_to_end,
                                 check_mesh_setup, check_mesh_stage2,
                                 check_module, check_param_tree_and_theta0,
                                 check_specs, _setup)

ARCH = "xlstm-1.3b"
MESH = {"arch": ARCH, "compressor": "block_topk"}
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _normal(rng, shape, scale=1.0, dtype=jnp.float32):
    return jnp.asarray(rng.standard_normal(shape) * scale,
                       jnp.float32).astype(dtype)


def test_mlstm_chunk_scan_matches_jax_over_four_chunks():
    """S 32 in chunks of 8 from a drawn state (C, n, m): y, the new state
    and every input's gradient, f32."""
    rng = np.random.default_rng(0)
    B, S, H, hd = 2, 32, 2, 8
    q, k, v = (_normal(rng, (B, S, H, hd)) for _ in range(3))
    ig = _normal(rng, (B, S, H), 2.0)
    log_f = jax.nn.log_sigmoid(_normal(rng, (B, S, H), 2.0))
    state = (_normal(rng, (B, H, hd, hd), 0.3), _normal(rng, (B, H, hd)),
             _normal(rng, (B, H)))
    check_module(lambda *a: JXL._mlstm_chunk_scan(*a, chunk=8),
                 lambda *a: XL.mlstm_chunk_scan(*a, chunk=8),
                 (q, k, v, ig, log_f, state), "float32")


def _params(init, cfg, seed, **drawn):
    p = jax.jit(lambda key: init(key, cfg))(jax.random.PRNGKey(seed))
    return dict(p, **drawn)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mlstm_matches_jax(dtype):
    """The block on the smoke config's shapes (head width di / H = 64) at
    S 32, chunk 8, with b_if drawn off its zeros."""
    cfg = REGISTRY[ARCH].smoke.scaled(dtype=dtype)
    jcfg = JREG[ARCH].smoke.scaled(dtype=dtype)
    rng = np.random.default_rng(1)
    p = _params(JXL.init_mlstm, jcfg, 1,
                b_if=_normal(rng, (2 * jcfg.num_heads,), 2.0))
    x = _normal(rng, (2, 32, jcfg.d_model), 1.0, jnp.dtype(dtype))
    check_module(lambda p, x: JXL.apply_mlstm(p, x, jcfg, chunk=8)[0],
                 lambda p, x: XL.apply_mlstm(p, x, cfg, chunk=8),
                 (p, x), dtype)


def _slstm_inputs(seed=2, S=24, B=2, d=16):
    rng = np.random.default_rng(seed)
    px = _normal(rng, (S, B, 4 * d), 1.5)
    wh = _normal(rng, (d, 4 * d), d ** -0.5)
    b = _normal(rng, (4 * d,), 0.5)
    state = (_normal(rng, (B, d)), jnp.asarray(
        rng.uniform(1.0, 3.0, (B, d)), jnp.float32), _normal(rng, (B, d)),
        _normal(rng, (B, d)))
    return px, wh, b, state


def _port_scan(px, wh, b, state):
    hs, *final = XL.SLSTMScan.apply(px, wh, b, *state)
    return hs, tuple(final)


def test_slstm_scan_and_its_backward_match_jax_custom_vjp():
    """hs, the final state and the gradients of px, W_h, b and the state
    under JAX's custom_vjp (a reverse loop, dW_h one contraction)."""
    check_module(JXL._slstm_scan, _port_scan, _slstm_inputs(), "float32")


def test_slstm_backward_matches_autograd_through_the_loop():
    """The Function's gradients against torch autograd through a plain loop
    of `slstm_cell` (which sums dW_h step by step), f32."""
    px, wh, b, state = (jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a).copy()).requires_grad_(), t) for t in _slstm_inputs(3))
    rng = np.random.default_rng(4)
    dhs = torch.from_numpy(rng.standard_normal(px.shape[:2] + (
        wh.shape[0],)).astype(np.float32))

    def loop():
        c, n, h, m = state
        hs = []
        for t in range(px.shape[0]):
            c, n, h, m = XL.slstm_cell(px[t] + h @ wh + b, c, n, m)
            hs.append(h)
        return torch.stack(hs)
    inputs = [px, wh, b, *state]
    want = torch.autograd.grad((loop() * dhs).sum(), inputs)
    got = torch.autograd.grad((_port_scan(px, wh, b, state)[0] * dhs).sum(),
                              inputs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w.numpy(), "float32", f"gradient {i}")


def test_slstm_cell_vjp_equals_autograd_of_the_cell():
    """`slstm_cell_vjp` against torch autograd of `slstm_cell` in f64,
    with ties planted in both maxima (log_f + m == ig, and n2 == 1 where
    the input gate underflows), where each splits its cotangent in
    two."""
    rng = np.random.default_rng(6)
    B, d = 4, 8
    pre = torch.from_numpy(rng.standard_normal((B, 4 * d)) * 2.0)
    c, m = (torch.from_numpy(rng.standard_normal((B, d))) for _ in "cm")
    n = torch.from_numpy(rng.uniform(0.5, 2.5, (B, d)))
    ig, fg = pre[:, :d], pre[:, d:2 * d]
    a = XL.log_sigmoid(fg) + m
    ig[0] = a[0]                           # log_f + m == ig
    ig[1] = a[1] - 1000.0                  # exp(ig - m_new) == 0 ...
    n[1] = 1.0                             # ... so n2 == 1
    cts = [torch.from_numpy(rng.standard_normal((B, d))) for _ in range(4)]
    ins = [t.clone().requires_grad_() for t in (pre, c, n, m)]
    want = torch.autograd.grad(XL.slstm_cell(*ins), ins, cts)
    got = XL.slstm_cell_vjp(pre, c, n, m, *cts)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=f"gradient {i}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_slstm_matches_jax(dtype):
    """The block on the smoke config's shapes at S 32, b drawn."""
    cfg = REGISTRY[ARCH].smoke.scaled(dtype=dtype)
    jcfg = JREG[ARCH].smoke.scaled(dtype=dtype)
    rng = np.random.default_rng(5)
    p = _params(JXL.init_slstm, jcfg, 2,
                b=_normal(rng, (4 * jcfg.d_model,), 1.0))
    x = _normal(rng, (2, 32, jcfg.d_model), 1.0, jnp.dtype(dtype))
    check_module(lambda p, x: JXL.apply_slstm(p, x, jcfg)[0],
                 lambda p, x: XL.apply_slstm(p, x, cfg), (p, x), dtype)


def test_spec_matches_jax():
    check_specs(ARCH)


def test_param_tree_and_theta0_equal_jax():
    """mlstm_blocks (G 2, 1, ...) and slstm_blocks (G 2, ...) in JAX's
    order; theta0 bit for bit."""
    check_param_tree_and_theta0(ARCH)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_jax(dtype, monkeypatch):
    check_loss_and_grads(ARCH, dtype, monkeypatch, bf16_ref32=True)


def test_checkpoint_and_convert_carry_the_tree(tmp_path):
    check_checkpoint_and_convert(tmp_path, ARCH)


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """JAX's dump of 3 mesh steps of xlstm's smoke config, block top-K."""
    return _jax_run(tmp_path_factory, MESH)


def test_mesh_setup_batches_and_masks_equal_jax(mesh_ref):
    check_mesh_setup(_setup(ARCH, MESH), mesh_ref)


def test_mesh_stage2_with_jax_gradients(mesh_ref):
    check_mesh_stage2(ARCH, mesh_ref, MESH)


def test_mesh_end_to_end_matches_jax(mesh_ref):
    check_mesh_end_to_end(ARCH, mesh_ref, MESH)


def test_step_parity_cpu_against_cpu():
    """The card-against-CPU check of chip_smoke.py and the gpu tests, CPU
    on both sides, on the smoke config (block_topk wire): stage 2 bit for
    bit."""
    from repro_torch.launch.device_parity import step_parity
    out = step_parity("cpu", arch=ARCH, compressor="block_topk")
    assert out["max_abs_dtheta"] == 0.0 and \
        out["loss_cpu"] == out["loss_device"]
