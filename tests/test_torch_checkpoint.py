"""Checkpoints between the packages (`repro_torch/checkpoint/`): one file
format, so a checkpoint JAX writes resumes in the port and one the port
writes restores in JAX.

JAX's side is its real (data=4, model=1) smoke run in a subprocess
(`build_train_setup` + `train_step`, 2 steps, then `save_checkpoint` of
{"params", "e"}), the driver's coding overrides (group 32).

Tolerances and why: none.  A checkpoint carries bytes: restored params
and e are bit-equal to what was saved, and port steps from a restored
state are bit-equal to port steps from the same state loaded directly
(one device, one thread count).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import SRC, _state_dict
from _torch_cases import one_thread_module  # noqa: F401 (autouse)
from repro.checkpoint import checkpoint as jck
from repro.configs import REGISTRY as JREG
from repro.nn import Model as JModel
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.launch.train import TrainRun, build_train_setup
from repro_torch.launch.train_e2e import CODING_OVERRIDES

N, SHAPE, LR = 4, ShapeCfg("train", 32, 8), 5e-3

JAX_SAVE = textwrap.dedent(f"""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, warnings
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint import save_checkpoint
    from repro.compat import make_mesh
    from repro.configs import REGISTRY
    from repro.configs.common import ShapeCfg
    from repro.launch.train import (TrainRun, build_train_setup,
                                    make_batch_for_step)
    warnings.simplefilter("ignore")
    spec = REGISTRY["gemma2-2b"]
    spec = dataclasses.replace(spec, coding=dataclasses.replace(
        spec.coding, **{CODING_OVERRIDES!r}))
    mesh = make_mesh((4, 1), ("data", "model"))
    shape = ShapeCfg("train", {SHAPE.seq_len}, {SHAPE.global_batch})
    setup = build_train_setup(spec, mesh, shape, TrainRun(base_lr={LR}),
                              smoke=True)
    key = jax.random.PRNGKey(0)
    params, e, opt = setup.init_state(key)
    step = jax.jit(setup.train_step)
    for t in range(2):
        batch = make_batch_for_step(setup, spec, shape, key, t, smoke=True)
        params, e, opt, m = step(params, e, opt, batch, jnp.int32(t), key)
    save_checkpoint(sys.argv[1], 2, {{"params": params, "e": e}})
    out = {{"e": np.asarray(e), "flat_pad": setup.flat_pad}}
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p0/" + "/".join(k.key for k in p)] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """(checkpoint directory, JAX's params and e at step 2)."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    dump = d / "state.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", JAX_SAVE, str(d / "ckpt"),
                        str(dump)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return d / "ckpt", dict(np.load(dump))


def _setup():
    spec = REGISTRY["gemma2-2b"]
    spec = dataclasses.replace(spec, coding=dataclasses.replace(
        spec.coding, **CODING_OVERRIDES))
    return build_train_setup(spec, SHAPE, TrainRun(base_lr=LR), smoke=True,
                             n_code=N, device="cpu")


def _two_steps(setup, e, first: int):
    losses = []
    for t in (first, first + 1):
        losses.append(setup.train_step(setup.model, e, setup.make_batch(t),
                                       t)["loss"].item())
    return losses


def test_jax_checkpoint_resumes_in_the_port(jax_ckpt):
    """The port restores JAX's step-2 checkpoint (params and e bit-equal
    to JAX's state), and its steps 2 and 3 from there equal its steps 2
    and 3 from the same state loaded directly, bit for bit."""
    path, ref = jax_ckpt
    assert ck.latest_step(path) == 2
    a = _setup()
    assert a.flat_pad == int(ref["flat_pad"])
    e_a = a.init_state()
    step, _ = ck.restore_checkpoint(path, {"params": a.model.params(),
                                           "e": e_a.view(N, 1, -1)})
    assert step == 2
    np.testing.assert_array_equal(e_a.numpy(), ref["e"].reshape(N, -1))
    b = _setup()
    b.model.load_params(_state_dict(ref))
    e_b = torch.from_numpy(ref["e"].reshape(N, -1).copy())
    np.testing.assert_array_equal(a.model.theta.numpy(),
                                  b.model.theta.numpy())
    assert _two_steps(a, e_a, 2) == _two_steps(b, e_b, 2)
    np.testing.assert_array_equal(a.model.theta.numpy(),
                                  b.model.theta.numpy())
    np.testing.assert_array_equal(e_a.numpy(), e_b.numpy())


def _port_state():
    s = _setup()
    e = s.init_state()
    _two_steps(s, e, 0)
    return s, e


@pytest.mark.parametrize("codec", ("raw", "zstd"))
def test_port_checkpoint_restores_in_jax(tmp_path, monkeypatch, codec):
    """JAX's restore_checkpoint with JAX's templates reads the port's file
    (either codec) into params and e bit-equal to the port's."""
    if codec == "raw":
        monkeypatch.setattr(ck, "zstandard", None)
    s, e = _port_state()
    path = ck.save_checkpoint(tmp_path, 2, {"params": s.model.params(),
                                            "e": e.view(N, 1, -1)},
                              extra={"note": "port"})
    assert path.name == "ckpt_0000000002.rpr"
    assert not [p for p in tmp_path.iterdir() if p != path]   # no tmp left
    tmpl = {"params": JModel(JREG["gemma2-2b"].smoke).param_shapes(),
            "e": jnp.zeros((N, 1, s.flat_pad), jnp.float32)}
    step, out = jck.restore_checkpoint(tmp_path, tmpl)
    assert step == 2
    got = convert.params_from_jax(jax.tree.map(np.asarray, out["params"]))
    want = s.model.params()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    np.testing.assert_array_equal(np.asarray(out["e"]).reshape(N, -1),
                                  e.numpy())


@pytest.mark.parametrize("codec", ("raw", "zstd"))
def test_codecs_round_trip_in_the_port(tmp_path, monkeypatch, codec):
    """Both codecs restore the port's own files bit for bit, into
    tensors of a fresh setup; the header names the codec."""
    if codec == "raw":
        monkeypatch.setattr(ck, "zstandard", None)
    s, e = _port_state()
    ck.save_checkpoint(tmp_path, 7, {"params": s.model.params(),
                                     "e": e.view(N, 1, -1)})
    raw = (tmp_path / "ckpt_0000000007.rpr").read_bytes()
    assert raw[:4] == ck.MAGIC and f'"codec": "{codec}"'.encode() in raw
    t = _setup()
    e_t = torch.zeros_like(e)
    assert ck.restore_checkpoint(tmp_path, {"params": t.model.params(),
                                            "e": e_t.view(N, 1, -1)})[0] == 7
    assert torch.equal(t.model.theta, s.model.theta)
    assert torch.equal(e_t, e)
    with pytest.raises(ValueError):                # (N, flat) is not saved
        ck.restore_checkpoint(tmp_path, {"e": e_t})


def test_zstd_without_zstandard_raises_jax_message(tmp_path, monkeypatch):
    s, e = _port_state()
    ck.save_checkpoint(tmp_path, 1, {"e": e.view(N, 1, -1)})
    monkeypatch.setattr(ck, "zstandard", None)
    monkeypatch.setattr(jck, "zstandard", None)
    with pytest.raises(ModuleNotFoundError) as want:
        jck.restore_checkpoint(tmp_path, {"e": np.zeros((N, 1, s.flat_pad),
                                                        np.float32)})
    with pytest.raises(ModuleNotFoundError) as got:
        ck.restore_checkpoint(tmp_path, {"e": e.view(N, 1, -1)})
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(tmp_path / "none", {})
    assert ck.latest_step(tmp_path / "none") is None


@pytest.mark.parametrize("old,new,flat", (((4, 1), (2, 1), 96),
                                          ((2, 1), (4, 1), 160),
                                          ((2, 2, 2), (2, 3, 1), 128),
                                          ((4, 1), (4, 1), 128)))
def test_elastic_rescale_ef_equals_jax(old, new, flat):
    rng = np.random.default_rng(len(old) + flat)
    e_old = rng.standard_normal(old + (128,)).astype(np.float32)
    got = ck.elastic_rescale_ef(e_old, old, new, flat)
    want = jck.elastic_rescale_ef(e_old, old, new, flat)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
