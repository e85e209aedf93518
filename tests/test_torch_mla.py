"""The port's MLA (`repro_torch.nn.layers.mla_train`) and
deepseek-v2-lite-16b's stack against the JAX package (`repro.nn.layers`'
MLA, `repro.nn.transformer`'s deepseek family) on the CPU, on one torch
thread.

  - module level: `mla_train`'s output and the gradient of every input
    under a seeded random cotangent (`jax.vjp`), at `test_torch_families.
    assert_close`'s tolerances (f32 rtol 1e-5 / atol 1e-6 at unit scale;
    bf16 within 5% of the largest magnitude or twice JAX's own bf16
    error), on the smoke config's widths (q.k 24 wide, v 16) with kv_norm
    drawn off its ones;
  - the stack (smoke config: block0 with a dense MLP of dense_ff 128, then
    2 MLA + MoE blocks with one shared expert): spec, leaf names, shapes
    and order, theta0 bit for bit, loss and every gradient leaf in f32
    and bf16 (bf16 on JAX's routing, fed into both, as
    test_torch_families.py does for olmoe; the shared experts pass
    through the port's MoE layer against JAX's at model level here), an
    RPR1 checkpoint both ways and `convert`'s round trip;
  - the slice: the training driver `train_e2e.run --arch
    deepseek-v2-lite-16b --device cpu` (its sign wire at g 32): finite
    losses, each rank's dropped assignments recorded, and a resume from
    a checkpoint equal to the straight run bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import one_thread
from repro.configs import REGISTRY as JREG
from repro.nn import layers as JL
from repro_torch.configs import REGISTRY
from repro_torch.nn import layers as L
from test_torch_driver import _run
from test_torch_families import (check_checkpoint_and_convert,
                                 check_loss_and_grads, check_module,
                                 check_param_tree_and_theta0, check_specs)

ARCH = "deepseek-v2-lite-16b"
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_train_matches_jax(dtype):
    cfg = REGISTRY[ARCH].smoke.scaled(dtype=dtype)
    jcfg = JREG[ARCH].smoke.scaled(dtype=dtype)
    rng = np.random.default_rng(0)
    p = jax.jit(lambda k: JL.init_mla(k, jcfg))(jax.random.PRNGKey(1))
    p = dict(p, kv_norm=jnp.asarray(
        rng.uniform(0.5, 1.5, jcfg.kv_lora_rank), jnp.float32))
    x = jnp.asarray(rng.standard_normal((2, 32, jcfg.d_model)),
                    jnp.float32).astype(jnp.dtype(dtype))
    check_module(lambda p, x: JL.mla_train(p, x, jcfg),
                 lambda p, x: L.mla_train(p, x, cfg), (p, x), dtype)


def test_spec_matches_jax():
    check_specs(ARCH)


def test_param_tree_and_theta0_equal_jax():
    """block0 before blocks (L - 1, ...) in JAX's order; theta0 bit for
    bit."""
    check_param_tree_and_theta0(ARCH)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_jax(dtype, monkeypatch):
    check_loss_and_grads(ARCH, dtype, monkeypatch, bf16_ref32=True)


def test_checkpoint_and_convert_carry_the_tree(tmp_path):
    check_checkpoint_and_convert(tmp_path, ARCH)


def test_driver_trains_deepseek_and_resumes_bit_exact(tmp_path, capsys):
    """`python -m repro_torch.launch.train_e2e --arch deepseek-v2-lite-16b
    --device cpu --steps 4 --ckpt-every 2`, then again with --steps 6:
    finite losses, each step's dropped assignments a rank, a resume from
    step 4 ending on the bits of 6 straight steps."""
    first = _run(tmp_path, "ckpt", "--steps", "4", "--ckpt-every", "4",
                 arch=ARCH)
    assert first["setup"].model.cfg.family == "deepseek"
    assert f"arch={ARCH}" in capsys.readouterr().out
    for r in first["steps"]:
        assert np.isfinite(r["loss"])
        assert len(r["moe_dropped"]) == first["setup"].n_code
    resumed = _run(tmp_path, "ckpt", "--steps", "6", "--ckpt-every", "100",
                   arch=ARCH)
    assert "resumed from step 4" in capsys.readouterr().out
    straight = _run(tmp_path, "straight", "--steps", "6", "--ckpt-every",
                    "100", arch=ARCH)
    want = {r["step"]: r["loss"] for r in straight["steps"]}
    for r in first["steps"] + resumed["steps"]:
        assert r["loss"] == want[r["step"]]
    assert torch.equal(resumed["e"], straight["e"])
    assert torch.equal(resumed["setup"].model.theta,
                       straight["setup"].model.theta)


def test_step_parity_cpu_against_cpu():
    """The card-against-CPU check of chip_smoke.py and the gpu tests, CPU
    on both sides, on the smoke config (sign wire): stage 2 bit for
    bit."""
    from repro_torch.launch.device_parity import step_parity
    out = step_parity("cpu", arch=ARCH, compressor="sign")
    assert out["max_abs_dtheta"] == 0.0 and \
        out["loss_cpu"] == out["loss_device"]
