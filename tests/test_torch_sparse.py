"""The port's block top-K wire (plain versions of its kernels, on the CPU)
against the JAX package: its jnp references, bit for bit, and its Pallas
kernels in interpret mode, by value.

Tolerances and why:
  - against `repro.kernels.ref` (jnp): every output bit-equal, signed zeros
    included.  The port takes a selected value itself, as the jnp
    reference does.
  - against the Pallas kernels: equal by value (-0.0 == +0.0).  Their
    masked sums turn a selected -0.0 into +0.0 (ROADMAP C7, pinned by
    `test_signed_zeros_follow_the_jnp_reference`).  The Pallas
    `ef_topk_fused` writes gamma * g + e with no barrier, and XLA:CPU
    contracts it into an FMA in interpret mode (ROADMAP C4); with gamma a
    power of two the product is exact, so the FMA rounds as the two-op
    accumulate does, and these comparisons use gamma = 0.5.
  - decode: bit-equal to Pallas and to the sender-order scan.
XLA:CPU flushes denormal f32 to zero, the port keeps IEEE denormals
(ROADMAP C6), results included: the comparisons use a tiny block whose
|acc| >= 2**-103, so that no acc and no rounding error of e' = acc - c is
denormal, and `test_denormals_follow_ieee_not_xla_flush` pins the
divergence.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import GAMMA, topk_inputs, topk_payload
from repro.core.collectives import SparseWire as JaxSparseWire
from repro.kernels import ref as jref, topk_pack as jtp
from repro_torch.core.collectives import SparseWire, build_wire
from repro_torch.core.cocoef import CocoEFConfig, cocoef_update
from repro_torch.kernels import ops, ref, topk_pack as tp

PALLAS_GAMMA = np.float32(0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    """numpy f32/i32 view of a port or JAX array (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else \
            x.to(torch.int32) if x.dtype == torch.uint16 else x
        return x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _bits_equal(a, b):
    a, b = _np(a), _np(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), np.asarray(b, np.float32).view(np.int32)
    np.testing.assert_array_equal(a, b)


CASES = [(64, 1), (64, 8), (256, 1), (256, 8), (256, 32), (512, 8),
         (512, 32)]


@pytest.mark.parametrize("block_size,k", CASES)
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [0.0, 1.0])
def test_ef_topk_fused_matches_jax(block_size, k, value_dtype, mask):
    n = block_size * 8 * 2
    g, e = topk_inputs(n, block_size, k, seed=block_size + k,
                       denormals=False)
    port = ops.ef_topk_fused(_t(g), _t(e), GAMMA, mask, k, block_size,
                             value_dtype, want_c=True)
    jnp_out = jref.ef_topk_fused_ref(jnp.asarray(g), jnp.asarray(e), GAMMA,
                                     jnp.float32(mask), k, block_size,
                                     value_dtype)
    for a, b in zip(port, jnp_out):
        _bits_equal(a, b)
    port = ops.ef_topk_fused(_t(g), _t(e), PALLAS_GAMMA, mask, k, block_size,
                             value_dtype, want_c=True)
    pallas = jtp.ef_topk_fused(jnp.asarray(g), jnp.asarray(e), PALLAS_GAMMA,
                               jnp.float32(mask), k, block_size, want_c=True,
                               value_dtype=value_dtype, interpret=True)
    for a, b in zip(port, pallas):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("block_size,k", CASES)
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_topk_pack_matches_jax(block_size, k, value_dtype):
    n = block_size * 8 * 2
    g, e = topk_inputs(n, block_size, k, seed=k, denormals=False)
    x = g + e
    idx, val, scales = ops.topk_pack(_t(x), k, block_size, value_dtype)
    assert idx.dtype == torch.uint16
    assert val.dtype == ref.wire_dtype(value_dtype)
    ji, jv, js = jref.topk_pack_ref(jnp.asarray(x), k, block_size)
    _bits_equal(idx, ji)
    _bits_equal(val, jv.astype(value_dtype))
    _bits_equal(scales, js)
    pi, pv, ps = jtp.topk_pack(jnp.asarray(x), k, block_size, interpret=True)
    np.testing.assert_array_equal(_np(idx), np.asarray(pi))
    np.testing.assert_array_equal(_np(val), _np(pv.astype(value_dtype)))
    np.testing.assert_array_equal(_np(scales), np.asarray(ps))


@pytest.mark.parametrize("block_size,k,k_send", [(256, 8, 1), (256, 8, 2),
                                                  (256, 8, 4), (512, 32, 7),
                                                  (64, 8, 8)])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [0.0, 1.0])
def test_budgeted_fused_step_is_jax_budget_branch(block_size, k, k_send,
                                                   value_dtype, mask):
    """The fused step with a rank's budget k_send (`ef_topk_fused`'s plain
    version, which the kernel matches bit for bit) against JAX's budget
    branch on one chunk (`repro/core/cocoef.py:308-318`): pack k slots,
    zero the values past the budget, c = unpack, e' = mask ? acc - c : e.
    Every output bit for bit; the pack with the same budget too."""
    n = block_size * 8 * 2
    g, e = topk_inputs(n, block_size, k, seed=block_size + k_send,
                       denormals=False)
    port = ops.ef_topk_fused(_t(g), _t(e), GAMMA, mask, k, block_size,
                             value_dtype, want_c=True, k_send=k_send)
    jw = JaxSparseWire((k_send, k), block_size, value_dtype)
    acc = jref.mul_add(GAMMA, jnp.asarray(g), jnp.asarray(e))
    payload = jw.apply_rank_budget(jw.pack(acc), 0)
    c = jw.unpack(payload)
    e_new = jnp.where(jnp.float32(mask) > 0, acc - c, jnp.asarray(e))
    for a, b in zip(port, (*payload, c, e_new)):
        _bits_equal(a, b)
    packed = ops.topk_pack(_t(np.asarray(acc)), k, block_size, value_dtype,
                           k_send=k_send)
    for a, b in zip(packed, payload):
        _bits_equal(a, b)


@pytest.mark.parametrize("block_size,k", [(64, 8), (256, 1), (256, 8),
                                          (512, 32)])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_topk_decode_reduce_matches_jax(block_size, k, value_dtype):
    N, nb = 4, 8 * 3
    idx, val, scales, mask = topk_payload(N, nb, k, block_size, seed=k)
    val = _np(jnp.asarray(val).astype(value_dtype))      # wire-rounded
    port = ops.topk_decode_reduce(
        _t(idx).to(torch.uint16), _t(val).to(ref.wire_dtype(value_dtype)),
        _t(scales), _t(mask), block_size).numpy()
    args = (jnp.asarray(idx, jnp.int32), jnp.asarray(val),
            jnp.asarray(scales), jnp.asarray(mask))
    pallas = np.asarray(jtp.topk_decode_reduce(*args, block_size,
                                               interpret=True))
    scan = np.asarray(jref.topk_decode_reduce_scan(*args, block_size))
    np.testing.assert_array_equal(port.view(np.int32), pallas.view(np.int32))
    np.testing.assert_array_equal(port.view(np.int32), scan.view(np.int32))


def test_tie_order_is_lax_top_k_not_torch_topk():
    """ROADMAP C1: |x| = [1,3,3,2,3,0,3,3], k = 3 -> [1, 2, 4] (first
    occurrence wins), where torch.topk gives another order."""
    x = torch.tensor([[1, -3, 3, 2, -3, 0, 3, 3]], dtype=torch.float32)
    idx, sv = ref.topk_select(x, 3)
    assert idx.tolist() == [[1, 2, 4]]
    assert sv.tolist() == [[-3.0, 3.0, -3.0]]
    assert torch.topk(x.abs(), 3).indices.tolist() != [[1, 2, 4]]
    xb = torch.zeros(64)
    xb[:8] = x[0]
    i, v, s = ops.topk_pack(xb, 3, 64)
    assert i.tolist() == [[1, 2, 4]] and s.item() == 3.0
    ji = jref.topk_pack_ref(jnp.asarray(xb.numpy()), 3, 64)[0]
    assert np.asarray(ji).tolist() == [[1, 2, 4]]


def test_signed_zeros_follow_the_jnp_reference():
    """ROADMAP C7: on a block of -0.0 the port and JAX's jnp reference keep
    the selected -0.0 in val and c; the Pallas kernel's masked sums give
    +0.0, so the bits of val, c and e' differ, the values do not."""
    B, k = 64, 8
    g = np.full(B * 8, -0.0, np.float32)
    e = np.full(B * 8, -0.0, np.float32)
    port = ops.ef_topk_fused(_t(g), _t(e), PALLAS_GAMMA, 1.0, k, B,
                             want_c=True)
    jnp_out = jref.ef_topk_fused_ref(jnp.asarray(g), jnp.asarray(e),
                                     PALLAS_GAMMA, jnp.float32(1.0), k, B)
    pallas = jtp.ef_topk_fused(jnp.asarray(g), jnp.asarray(e), PALLAS_GAMMA,
                               jnp.float32(1.0), k, B, want_c=True,
                               interpret=True)
    for a, b in zip(port, jnp_out):
        _bits_equal(a, b)
    val, c, e_new = port[1].numpy(), port[3].numpy(), port[4].numpy()
    assert np.all(np.signbit(val)) and np.all(port[2].numpy() == 1.0)
    assert np.signbit(c).sum() == 8 * k                  # the kept -0.0
    assert not np.signbit(e_new[port[0][0].long().numpy()]).any()  # -0 - -0
    pv, pc, pe = (np.asarray(pallas[i]) for i in (1, 3, 4))
    assert not np.signbit(pv).any() and not np.signbit(pc).any()
    assert np.signbit(pe).all()                          # -0 - (+0)
    for a, b in ((val, pv), (c, pc), (e_new, pe)):
        np.testing.assert_array_equal(a, b)              # equal by value
        assert not np.array_equal(a.view(np.int32), b.view(np.int32))


def test_denormals_follow_ieee_not_xla_flush():
    """ROADMAP C6: a block of denormal accumulators.  The port selects the
    largest IEEE magnitudes; XLA:CPU flushes them to zero, so JAX sees a
    zero block, keeps its first k positions and scale 1.0."""
    B, k = 64, 4
    g, e = topk_inputs(B * 8, B, k, seed=5)
    acc = (GAMMA * g + e)[2 * B:3 * B]                   # numpy: IEEE f32
    assert np.all(np.abs(acc) < np.finfo(np.float32).tiny) and acc.any()
    idx, val, scales, c, e_new = ops.ef_topk_fused(_t(g), _t(e), GAMMA, 1.0,
                                                   k, B, want_c=True)
    want = np.argsort(-np.abs(acc), kind="stable")[:k]
    np.testing.assert_array_equal(idx[2].long().numpy(), want)
    assert scales[2].item() == np.abs(acc).max()
    ji, _, js, _, _ = jref.ef_topk_fused_ref(jnp.asarray(g), jnp.asarray(e),
                                             GAMMA, jnp.float32(1.0), k, B)
    assert np.asarray(ji)[2].tolist() == list(range(k))  # flushed: all 0
    assert float(js[2]) == 1.0


def test_wire_bytes_match_the_notes_table():
    n = 4_194_304
    assert SparseWire(8, 512).wire_bytes(n) == 425_984
    assert SparseWire(8, 512, "bfloat16").wire_bytes(n) == 294_912
    assert SparseWire(32, 512).wire_bytes(n) == 1_605_632
    for ks in (8, (8, 8, 4, 2), (32, 1, 16, 5)):
        for vd in ("float32", "bfloat16"):
            w, jw = SparseWire(ks, 256, vd), JaxSparseWire(ks, 256, vd)
            assert w.wire_bytes(n) == jw.wire_bytes(n)
            np.testing.assert_array_equal(w.rank_wire_bytes(n, 4),
                                          jw.rank_wire_bytes(n, 4))
    assert SparseWire(8, 1 << 17).index_dtype == torch.uint32
    with pytest.raises(ValueError):
        SparseWire((8, 4), 256).rank_wire_bytes(n, 4)
    with pytest.raises(ValueError):
        SparseWire(8, 256).check(n + 128, nd=1)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_sparse_wire_matches_jax(value_dtype):
    """pack/unpack, the per-rank budget and the wire's bookkeeping against
    JAX's SparseWire on the same vector."""
    rng = np.random.default_rng(3)
    B, n, ks = 256, 256 * 16, (8, 8, 4, 2)
    x = rng.standard_normal(n).astype(np.float32)
    x[:B] = -0.0
    w, jw = SparseWire(ks, B, value_dtype), JaxSparseWire(ks, B, value_dtype)
    assert w.k_max == jw.k_max == 8 and w.has_rank_budgets()
    assert w.for_rank(3).k_per_block == 2 and w.alignment() == B
    for rank in range(4):
        p = w.apply_rank_budget(w.pack(_t(x)), rank)
        jp = jw.apply_rank_budget(jw.pack(jnp.asarray(x)), rank)
        for a, b in zip(p, jp):
            _bits_equal(a, b)
        _bits_equal(w.unpack(p), jw.unpack(jp))
        assert w.payload_n(p) == n
        fp = w.apply_rank_budget(w.fused_pack(_t(x)), rank)
        for a, b in zip(fp, p):
            _bits_equal(a, b)
    assert build_wire("block_topk", k_per_block=ks, block_size=B,
                      value_dtype=value_dtype) == w
    with pytest.raises(ValueError):
        build_wire("topk")


@pytest.mark.parametrize("k_per_block", [8, (8, 8, 4, 2)])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_cocoef_update_matches_the_jnp_composition(k_per_block, value_dtype):
    """The port's stage 2 for N = 4 ranks sharing one gradient buffer,
    uniform (fused step) and per-rank budgets (pack, budget, unpack), held
    bitwise against JAX's jnp references composed as JAX's cocoef_update
    does (`repro/core/cocoef.py:308-321`), then the sender-order decode."""
    N, B, n = 4, 256, 256 * 8 * 4
    cfg = CocoEFConfig(group_size=32, compressor="block_topk",
                       k_per_block=k_per_block, block_size=B,
                       wire_dtype=value_dtype)
    assert cfg.pad_multiple == 256
    rng = np.random.default_rng(1)
    grads = (rng.standard_normal((N, n)) * 3).astype(np.float32)
    e0 = (rng.standard_normal((N, n)) * 0.1).astype(np.float32)
    for i in range(N):
        grads[i, :B * 6], e0[i, :B * 6] = topk_inputs(B * 6, B, 8, seed=i,
                                                      denormals=False)
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    nb, wire = n // B, cfg.wire
    payload = (torch.zeros((N, nb, 8), dtype=torch.uint16),
               torch.zeros((N, nb, 8), dtype=ref.wire_dtype(value_dtype)),
               torch.zeros((N, nb)))
    e = _t(e0)
    buf = torch.empty(n)

    def grad_of(i):
        buf.copy_(_t(grads[i]))
        return buf
    ghat = cocoef_update(grad_of, e, _t(mask), GAMMA, cfg, payload)

    jw = JaxSparseWire(k_per_block, B, value_dtype)
    want_p, want_e = [], []
    for i in range(N):
        g_i, e_i = jnp.asarray(grads[i]), jnp.asarray(e0[i])
        if jw.has_rank_budgets():
            acc = jref.mul_add(GAMMA, g_i, e_i)
            p = jw.apply_rank_budget(jw.pack(acc), i)
            en = jnp.where(mask[i] > 0, acc - jw.unpack(p), e_i)
        else:
            idx, val, sc, _, en = jref.ef_topk_fused_ref(
                g_i, e_i, GAMMA, jnp.float32(mask[i]), 8, B, value_dtype)
            p = (idx, val, sc)
        want_p.append(p)
        want_e.append(en)
    for j in range(3):
        _bits_equal(payload[j], jnp.stack([p[j] for p in want_p]))
    _bits_equal(e, jnp.stack(want_e))
    _bits_equal(e[1], e0[1])                              # the straggler
    jghat = jref.topk_decode_reduce_scan(
        *(jnp.stack([p[j] for p in want_p]).astype(
            jnp.int32 if j == 0 else jnp.float32) for j in range(3)),
        jnp.asarray(mask), B)
    _bits_equal(ghat, jghat)


def test_bad_inputs_raise():
    x = torch.zeros(8 * 64)
    with pytest.raises(ValueError):
        ops.topk_pack(x, 0, 64)                           # k < 1
    with pytest.raises(ValueError):
        ops.topk_pack(x, 65, 64)                          # k > B
    with pytest.raises(ValueError):
        ops.topk_pack(x[:100], 8, 64)                     # n % B
    with pytest.raises(TypeError):
        ops.topk_pack(x.double(), 8, 64)
    with pytest.raises(ValueError):
        ops.topk_pack(x, 8, 64, value_dtype="float16")
    with pytest.raises(ValueError):                       # k_send > k
        ops.topk_pack(x, 8, 64, k_send=9)
    with pytest.raises(ValueError):                       # k_send < 1
        ops.ef_topk_fused(x, x, 0.5, 1.0, 8, 64, k_send=0)
    with pytest.raises(ValueError):
        SparseWire(0, 256)
    with pytest.raises(ValueError):
        CocoEFConfig(compressor="randk")
    short = CocoEFConfig(compressor="block_topk", k_per_block=(8, 4),
                         block_size=64)
    with pytest.raises(ValueError):                       # 2 budgets, 4 ranks
        cocoef_update(lambda i: torch.zeros(512), torch.zeros((4, 512)),
                      torch.ones(4), 0.5, short, ())
    # what only the CUDA kernels refuse (checked before any launch)
    cuda = torch.device("cuda")
    for n, k, B, vdt in ((1024, 8, 32, torch.float32),
                         (1024, 33, 256, torch.float32),
                         (1024, 8, 256, torch.float16)):
        with pytest.raises(ValueError):
            tp._check_shape(n, k, B, vdt, cuda)
    tp._check_shape(1024, 32, 512, torch.bfloat16, cuda)
