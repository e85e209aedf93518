"""The port's sign-wire kernels (plain versions, on the CPU) against the JAX
package: its Pallas kernels in interpret mode and its jnp references.

XLA:CPU flushes denormal f32 operands and results to zero; torch and the
CUDA kernels keep IEEE denormals (ROADMAP C6).  So the comparisons with
JAX use inputs whose tiny group is the smallest normals, and
`test_denormals_follow_ieee_not_xla_flush` pins the divergence itself.

Tolerances: words exact; group scales within XLA_ULP = 6 ulp: the port
sums a group in its CUDA kernel's order and XLA in its own, which no simple
order reproduces (ROADMAP C3; measured up to 5 ulp on these inputs, g = 32
to 512); c and e' exact where the scales agree, else within XLA_ULP ulp of
the scale (plus one rounding of e'); decode exact on identical payloads
(every product is exact, the sum runs in sender order).  The Pallas
kernel writes gamma * g + e with no barrier, and XLA:CPU contracts it into
an FMA in interpret mode, so against it e' may also differ by one ulp of
acc; the jnp reference keeps the two roundings and is held exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import GAMMA, check_ef_outputs, ef_inputs
from repro.core.collectives import wire_bytes_sign as jax_wire_bytes_sign
from repro.kernels import ref as jref, sign_pack as jsp
from repro_torch import resolve_device
from repro_torch.core.collectives import SignWire, wire_bytes_sign
from repro_torch.kernels import ops, ref, sign_pack as sp

XLA_ULP = 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("group_size", [32, 128, 512])
@pytest.mark.parametrize("mask", [0.0, 1.0])
def test_ef_sign_fused_matches_jax_pallas(group_size, mask):
    n = 8 * group_size * 6
    g, e = ef_inputs(n, group_size, seed=group_size, denormals=False)
    jax_out = jsp.ef_sign_fused(jnp.asarray(g), jnp.asarray(e), GAMMA,
                                jnp.float32(mask), group_size, want_c=True,
                                interpret=True)
    port = ops.ef_sign_fused(_t(g), _t(e), GAMMA, mask, group_size,
                             want_c=True)
    check_ef_outputs(tuple(map(_np, jax_out)),
                     tuple(x.numpy() for x in port), group_size, XLA_ULP,
                     fma_ref=True)
    jnp_out = jref.ef_sign_fused_ref(jnp.asarray(g), jnp.asarray(e), GAMMA,
                                     jnp.float32(mask), group_size)
    check_ef_outputs(tuple(map(_np, jnp_out)),
                     tuple(x.numpy() for x in port), group_size, XLA_ULP)


def test_denormals_follow_ieee_not_xla_flush():
    """The port keeps denormals (IEEE, as numpy does); XLA:CPU flushes them,
    so on a denormal group JAX packs every bit as + and the port does not."""
    G = 32
    g, e = ef_inputs(8 * G, G, seed=5)
    acc = (GAMMA * g + e)[2 * G:3 * G]                  # numpy: IEEE f32
    assert np.any(acc < 0) and np.all(acc != 0)
    w, s, c, e_new = ops.ef_sign_fused(_t(g), _t(e), GAMMA, 1.0, G,
                                       want_c=True)
    bits = (w.numpy()[2].astype(np.int64) >> np.arange(32)) & 1
    np.testing.assert_array_equal(bits, (acc >= 0).astype(np.int64))
    assert s.numpy()[2] == np.float32(np.abs(acc).sum() / np.float32(G))
    wj = np.asarray(jsp.ef_sign_fused(jnp.asarray(g), jnp.asarray(e), GAMMA,
                                      jnp.float32(1.0), G,
                                      interpret=True)[0])
    assert wj[2] == np.uint32(0xFFFFFFFF)              # flushed: all +0


def test_ef_sign_fused_in_place_and_no_cpu_launch_count():
    g, e = ef_inputs(8 * 32 * 4, 32, seed=3)
    before = dict(sp.launches)
    w, s, c, e_new = sp.ef_sign_fused(_t(g), _t(e), GAMMA, 1.0, 32)
    assert c is None                               # want_c=False default
    e2 = _t(e).clone()
    out = (torch.empty_like(w), torch.empty_like(s), e2)
    sp.ef_sign_fused(_t(g), e2, GAMMA, 1.0, 32, out=out)
    assert torch.equal(out[0], w) and torch.equal(out[1], s)
    assert torch.equal(e2, e_new)
    assert sp.launches == before                   # plain versions: no count


@pytest.mark.parametrize("group_size", [32, 128, 512])
def test_sign_decode_reduce_matches_jax(group_size):
    rng = np.random.default_rng(group_size)
    N, n = 4, 8 * group_size * 5
    words = rng.integers(0, 2**32, (N, n // 32), dtype=np.uint32)
    scales = np.abs(rng.standard_normal((N, n // group_size))
                    ).astype(np.float32)
    scales[1, :2] = 0.0
    scales[2, 2] = np.float32(1e-42)               # denormal scale
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    port = ops.sign_decode_reduce(_t(words), _t(scales), _t(mask),
                                  group_size).numpy()
    pallas = np.asarray(jsp.sign_decode_reduce(
        jnp.asarray(words), jnp.asarray(scales), jnp.asarray(mask),
        group_size, interpret=True))
    scan = np.asarray(jref.sign_decode_reduce_scan(
        jnp.asarray(words), jnp.asarray(scales), jnp.asarray(mask),
        group_size))
    np.testing.assert_array_equal(port.view(np.int32), pallas.view(np.int32))
    np.testing.assert_array_equal(port.view(np.int32), scan.view(np.int32))


def test_pack_unpack_and_mul_add_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(8 * 512).astype(np.float32)
    x[:64] = -0.0
    w0, s0 = jref.sign_pack_ref(jnp.asarray(x), 128)
    w1, s1 = ref.sign_pack_ref(_t(x), 128)
    np.testing.assert_array_equal(np.asarray(w0), w1.numpy())
    np.testing.assert_array_less(np.abs(np.asarray(s0).view(np.int32)
                                        - s1.numpy().view(np.int32)),
                                 XLA_ULP + 1)
    u0 = jref.sign_unpack_ref(w0, s0, 128)
    u1 = ref.sign_unpack_ref(_t(np.asarray(w0)), _t(np.asarray(s0)), 128)
    np.testing.assert_array_equal(np.asarray(u0), u1.numpy())
    wire = SignWire(group_size=128)
    np.testing.assert_array_equal(wire.unpack(wire.pack(_t(x))).numpy(),
                                  ref.sign_unpack_ref(w1, s1, 128).numpy())
    g = rng.standard_normal(4096).astype(np.float32)
    e = rng.standard_normal(4096).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jref.mul_add(GAMMA, jnp.asarray(g), jnp.asarray(e))),
        ref.mul_add(GAMMA, _t(g), _t(e)).numpy())


def test_wire_bytes_match_the_notes_table():
    n = 4_194_304
    assert wire_bytes_sign(n, 512) == 557_056 == jax_wire_bytes_sign(n, 512)
    assert SignWire(512).wire_bytes(n) == 557_056
    with pytest.raises(ValueError):
        SignWire(512).check(n + 32, nd=1)


def test_bad_inputs_raise():
    g = torch.zeros(8 * 32)
    with pytest.raises(ValueError):
        sp.ef_sign_fused(g, g.clone(), 1.0, 1.0, 48)     # g % 32 != 0
    with pytest.raises(TypeError):
        sp.ef_sign_fused(g.double(), g.double(), 1.0, 1.0, 32)
    with pytest.raises(ValueError):
        sp.sign_decode_reduce(torch.zeros((2, 8), dtype=torch.uint32),
                              torch.zeros((2, 3)), torch.ones(2), 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
