"""The dense wire (compressor "identity", f32 and bf16 values) and mode
"dense" (stochastic gradient coding: no compression, no error feedback)
against the JAX package.

The step: the port's train step against JAX's real one (`build_train_setup`
+ `train_step` on a (data=4, model=1) mesh of 4 host devices, in a
subprocess; the harness of tests/_torch_cases.py, the checks of
tests/_torch_wire_cases.py), gemma2-2b smoke config in float32, g = 32,
N = 4, d = 2, iid stragglers p = 0.1, on four runs: identity (f32 and
bf16, cocoef), identity coco and dense.  JAX also runs its stage 2 alone on
the mesh (`cocoef_update` in a shard_map) on the gradients, errors and
masks it dumped.  Tolerances:
  - stage 2 on JAX's gradients, against JAX's references composed as its
    cocoef_update does (eager, two roundings in gamma*g + e): payload, e',
    ghat and theta bit for bit; dense ghat bit for bit against the
    rank-order sum of mask_i * gamma*g_i, e untouched.
  - against JAX's mesh stage 2: bit for bit where gamma*g + e is not
    formed (dense, coco) or cancels (f32 identity: e' = acc - acc).
    Inside the mesh step XLA:CPU contracts gamma*g + e into one FMA
    despite the reference's optimization barrier (ROADMAP C12; measured:
    every e' of the bf16 run equals the FMA form), while the port rounds
    twice, so their acc differ by up to an ulp of gamma*g plus one of acc
    (u): bf16 e' is within u plus one bf16 ulp of acc (2**-7 |acc|), ghat
    within the sum of that over the ranks.
  - C5: XLA:CPU's 4-device psum of dense mode equals the rank-order sum
    from +0.0 bit for bit (measured on all three steps, and a pairwise sum
    differs), so the port's rank-order sum is asserted equal to it.
  - 3 steps of the whole step (the port's own stage 1): loss within rtol
    1e-4; theta within (t + 1) * 1e-6 on f32 identity, identity coco and
    dense (nothing can flip: stage 1's order moves the last bits only);
    bf16 identity within (t + 1) * N * 2**-7 * gamma * max |g| (one bf16
    rounding flipped per rank); fewer than 1% of the coordinates more
    than 1e-6 apart.
Plain-level cases hold DenseWire against JAX's (bytes, pack, the local
step, the decode) and the config's modes and wires."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import LR, N, STEPS
from _torch_cases import one_thread_module  # noqa: F401 (autouse)
from _torch_wire_cases import (RUNS, _bits, _equal, _t, dump,
                               end_to_end_matches_jax, setup_matches_jax,
                               stage2_with_jax_gradients,
                               step_parity_cpu_against_cpu)
from repro.core import collectives as jcoll
from repro.kernels import ref as jref
from repro_torch.core.cocoef import CocoEFConfig
from repro_torch.core.collectives import DenseWire, SparseWire, build_wire
from repro_torch.kernels import ref
from repro_torch.launch.train import TrainRun

NAMES = ["identity", "identity_bf16", "identity_coco", "dense"]


@pytest.fixture(scope="module", params=NAMES)
def run(request, tmp_path_factory):
    """(name, _port_setup keywords, JAX's dump with its mesh stage 2)."""
    return (request.param, dict(RUNS[request.param]),
            dump(tmp_path_factory, request.param))


def test_setup_matches_jax(run):
    setup_matches_jax(*run)


def test_stage2_with_jax_gradients(run):
    """JAX's stage-1 gradients and state at the start of each step go into
    the port's stage 2; against JAX's references on the same inputs, then
    against JAX's mesh stage 2 (tolerances in the module docstring)."""
    stage2_with_jax_gradients(*run)


def test_end_to_end_matches_jax(run):
    """The port's whole step (its own stage 1 from the converted params,
    JAX's batches and masks) for 3 steps (tolerances in the module
    docstring)."""
    end_to_end_matches_jax(*run)


@pytest.mark.parametrize("name", NAMES)
def test_step_parity_cpu_against_cpu(name):
    step_parity_cpu_against_cpu(name)


def test_dense_psum_is_the_rank_order_sum(tmp_path_factory):
    """ROADMAP C5, measured: XLA:CPU's 4-device psum (JAX's dense mode)
    sums in rank order from +0.0: bit for bit the port's rank-order sum,
    on every step; a pairwise sum differs on some steps."""
    ref_ = dump(tmp_path_factory, "dense")
    pairwise_differs = 0
    for t in range(STEPS):
        acc = (np.float32(LR) * ref_[f"g{t}"]).astype(np.float32)
        m = ref_[f"mask{t}"].astype(np.float32)
        terms = [m[i] * acc[i] for i in range(N)]
        order = np.zeros_like(terms[0])
        for x in terms:
            order = order + x
        for row in ref_[f"s2_ghat{t}"]:
            _equal(row, order)
        pairwise = (terms[0] + terms[1]) + (terms[2] + terms[3])
        pairwise_differs += int((_bits(pairwise) != _bits(order)).any())
    assert pairwise_differs > 0       # the check can tell the orders apart


@pytest.mark.parametrize("value_dtype,want", [("float32", 16_777_216),
                                              ("bfloat16", 8_388_608)])
def test_dense_wire_bytes_match_the_notes_table(value_dtype, want):
    n = 4_194_304
    w = build_wire("identity", value_dtype=value_dtype)
    assert isinstance(w, DenseWire) and w.alignment() == 1
    assert w.wire_bytes(n) == want == \
        jcoll.DenseWire(value_dtype=value_dtype).wire_bytes(n)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [1.0, 0.0])
def test_dense_wire_matches_jax(value_dtype, mask, monkeypatch):
    """DenseWire against JAX's: pack and unpack bit for bit; the local
    step the port runs (`local_chunks`, with the CHUNK made small here)
    equals JAX's base fused_local_step (c and e'), with -0.0, exact
    cancellation and values between bf16 neighbours; the fold, rank by
    rank, and decode_reduce equal JAX's sender-order decode."""
    from repro_torch.core import collectives
    monkeypatch.setattr(collectives, "CHUNK", 1000)
    rng = np.random.default_rng(5)
    n = 4_100
    g = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))).astype(
        np.float32)
    e = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    g[:64], e[:64] = -0.0, -0.0
    g[64:128], e[64:128] = 1.0, -np.float32(LR)
    w, jw = DenseWire(value_dtype), jcoll.DenseWire(value_dtype)
    (p,) = w.pack(_t(g))
    (jp,) = jw.pack(jnp.asarray(g))
    _equal(p.float(), np.asarray(jp).astype(np.float32))
    _equal(w.unpack((p,)), np.asarray(jw.unpack((jp,))))
    want = jw.fused_local_step(jnp.asarray(g), jnp.asarray(e),
                               jnp.float32(LR), jnp.float32(mask))
    gi, ei = _t(g), _t(e)
    c = torch.full((n,), float("nan"))
    for sl, cc in w.local_chunks(gi, ei, torch.tensor(LR),
                                 torch.tensor(mask)):
        c[sl] = cc
    _equal(gi, g)                         # g is not written
    _equal(c, want[1])
    _equal(ei, want[2])
    vals = np.stack([np.asarray(jp).astype(np.float32)] * 3)
    vals[1] *= -0.5
    m = np.array([1.0, 0.0, 1.0], np.float32)
    jg = jref.dense_decode_reduce_scan(jnp.asarray(vals).astype(
        jw.value_dtype), jnp.asarray(m))
    tv = _t(vals).to(ref.wire_dtype(value_dtype))
    _equal(w.decode_reduce((tv,), _t(m)), jg)
    acc = torch.zeros(n)
    for i in range(3):
        w.fold_(acc, tv[i].float(), _t(m)[i])
    _equal(acc, jg)


def test_modes_and_wires_of_the_config():
    """CocoEFConfig carries topk_k and sizes global top-K from (n, nd);
    the dense wire and dense mode fold into one accumulator."""
    cfg = CocoEFConfig(compressor="topk", group_size=32)
    assert cfg.topk_k == 64 and cfg.pad_multiple == 32 and not cfg.folds
    w = cfg.wire_format(2_660_229_120, 4)
    assert isinstance(w, SparseWire)
    assert (w.block_size, w.k_per_block) == (665_057_280, 16)
    assert w.index_dtype == torch.uint32
    with pytest.raises(ValueError):          # the block needs the size
        cfg.wire
    assert CocoEFConfig(compressor="identity").folds
    assert CocoEFConfig(mode="dense").folds
    assert CocoEFConfig(compressor="identity", mode="coco").pad_multiple \
        == 512
    with pytest.raises(ValueError):
        CocoEFConfig(compressor="topk", topk_k=0)
    with pytest.raises(ValueError):
        CocoEFConfig(compressor="identity", wire_dtype="float16")
    from repro_torch.configs import REGISTRY
    plan = REGISTRY["gemma2-2b"].coding
    for comp in ("identity", "topk"):
        c = TrainRun(compressor=comp).coding_config(plan, 4)
        assert c.compressor == comp and c.topk_k == plan.topk_k == 64
    with pytest.raises(ValueError):            # budgets need block_topk
        TrainRun(compressor="topk", k_budgets=(8, 8, 4, 2)).coding_config(
            plan, 4)
