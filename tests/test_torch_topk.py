"""Global top-K (compressor "topk": one block of n / nd per all_to_all
chunk, k = ceil(topk_k / nd)) against the JAX package.

The step: the port's train step against JAX's real one (`build_train_setup`
+ `train_step` on a (data=4, model=1) mesh of 4 host devices, in a
subprocess; the harness of tests/_torch_cases.py, the checks of
tests/_torch_wire_cases.py), gemma2-2b smoke config in float32, g = 32,
N = 4, d = 2, iid stragglers p = 0.1, k = 16 of each chunk of 41,120, on
two runs: cocoef and coco.  JAX also runs its stage 2 alone on the mesh
(`cocoef_update` in a shard_map) on the gradients, errors and masks it
dumped.  Tolerances:
  - stage 2 on JAX's gradients, against JAX's references composed as its
    cocoef_update does (eager, two roundings in gamma*g + e, `lax.top_k`):
    payload exact and e' exact on every chunk with no denormal acc or e'
    (ROADMAP C6; the smoke data has none), ghat and theta bit for bit.
  - against JAX's mesh stage 2: coco bit for bit; cocoef: inside the mesh
    step XLA:CPU contracts gamma*g + e into one FMA (ROADMAP C12), while
    the port rounds twice, so their acc differ by up to an ulp of gamma*g
    plus one of acc (u): e' within u off the two kept sets (at most 2 k a
    chunk), and e', ghat and theta within N * (max chunk scale), the most
    a swapped selection moves them.
  - 3 steps of the whole step (the port's own stage 1): loss within rtol
    1e-4; theta within (t + 1) * N * (max scale), and fewer than 1% of the
    coordinates more than 1e-6 apart.
Plain-level cases hold the global route (`kernels/topk_pack.py`: rounds of
B6's plain version, gathers, one stable sort) against the stable sort of
whole chunks, and the topk wire against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import KB, topk_chunks
from _torch_cases import one_thread_module  # noqa: F401 (autouse)
from _torch_wire_cases import (RUNS, _bits, _equal, _t, dump,
                               end_to_end_matches_jax, setup_matches_jax,
                               stage2_with_jax_gradients,
                               step_parity_cpu_against_cpu)
from repro.core.plan import build_wire as jbuild_wire
from repro.kernels import ref as jref
from repro_torch.core.collectives import build_wire
from repro_torch.kernels import ref, topk_pack as tp

NAMES = ["topk", "topk_coco"]


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


@pytest.mark.parametrize("nd,B", [(4, 41_120), (3, 70_000), (2, 1_000),
                                  (4, 4_096)])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_global_route_matches_plain(nd, B, value_dtype):
    """The global route (rounds of B6's plain version on the CPU, gathers,
    one stable sort of the last candidates) against the stable sort of
    whole chunks: payload, c, e' and acc bit for bit, straggler or not;
    B > 65,536 gets u32 indices."""
    n = nd * B
    g = topk_chunks(nd, B, seed=B)
    e = (np.random.default_rng(nd).standard_normal(n) * 1e-3).astype(
        np.float32)
    e[B:3 * B] = -0.0
    e[[1, B - 2]] = 0.0                   # the tie stays exact
    e[300:300 + KB - 1] = 0.0
    gamma = torch.tensor(1.0)     # acc = g + e, the tie and zeros exact
    for mask in (1.0, 0.0):
        want = ref.ef_topk_fused_ref(_t(g), _t(e), gamma, mask, KB, B,
                                     value_dtype)
        gt, et = _t(g), _t(e)
        got = tp.ef_topk_global(gt, et, gamma, torch.tensor(mask), KB, B,
                                value_dtype, want_c=True,
                                out=tp._payload_out(
                                    None, nd, KB, B,
                                    ref.wire_dtype(value_dtype), gt.device)
                                + (et,))
        assert got[0].dtype == tp.index_dtype(B) == (
            torch.uint32 if B > 65536 else torch.uint16)
        _equal(got[0].to(torch.int64), want[0].to(torch.int64))
        _equal(got[1].float(), want[1])
        for a, b in zip(got[2:], want[2:]):
            _equal(a, b)
        _equal(gt, ref.mul_add(gamma, _t(g), _t(e)))     # g holds acc
        assert got[0][0, 15].item() == 1                 # the tie's first
        if mask == 0.0:
            _equal(et, e)
    x = _t(g)
    packed = tp.topk_pack_global(x, KB, B, value_dtype)
    want = ref.topk_pack_ref(x, KB, B)
    _equal(packed[0].to(torch.int64), want[0].to(torch.int64))
    _equal(packed[1].float(), want[1].to(ref.wire_dtype(value_dtype)
                                         ).float())
    _equal(packed[2], want[2])


def test_global_select_ties_across_chunks_and_rounds():
    """Equal magnitudes everywhere: every chunk keeps its first KB
    positions in order, through three rounds of B6 (and chunks equal to
    one another do not mix)."""
    nd, B = 3, 256 * 300
    x = torch.where(torch.arange(nd * B) % 3 == 0, -1.5, 1.5)
    pos, vals = tp.global_select(x, KB, nd)
    assert pos.tolist() == [list(range(KB))] * nd
    _equal(vals, x.view(nd, B)[:, :KB])
    y = torch.zeros(nd * B)                 # all zero, -0.0 included
    y[1::2] = -0.0
    pos, vals = tp.global_select(y, KB, nd)
    assert pos.tolist() == [list(range(KB))] * nd
    _equal(vals, y.view(nd, B)[:, :KB])


def test_global_decode_matches_the_scan():
    """The union decode against JAX's sender-order scan: a sender that
    kept a position another did not adds mask * +0.0 there (so a lone
    -0.0 value decodes to +0.0), a straggler's values count for nothing,
    positions kept by several senders sum in order."""
    N_, nd, B, k = 4, 3, 1_000, 5
    rng = np.random.default_rng(3)
    idx = np.stack([np.stack([rng.choice(B, k, replace=False)
                              for _ in range(nd)]) for _ in range(N_)])
    idx[1, 0] = idx[0, 0]                   # shared positions
    idx[2, 1, :2] = idx[0, 1, 3:]
    val = rng.uniform(-1, 1, (N_, nd, k)).astype(np.float32)
    val[0, 2, 0] = -0.0
    sc = np.exp(rng.uniform(-3, 3, (N_, nd))).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    want = jref.topk_decode_reduce_scan(
        jnp.asarray(idx.astype(np.int32)), jnp.asarray(val), jnp.asarray(sc),
        jnp.asarray(mask), B)
    got = tp.topk_decode_global(_t(idx.astype(np.int32)), _t(val), _t(sc),
                                _t(mask), B)
    _equal(got, np.asarray(want))
    assert _bits(got)[idx[0, 2, 0] + 2 * B] == 0            # +0, not -0
    _equal(got, ref.topk_decode_reduce_ref(_t(idx), _t(val), _t(sc),
                                           _t(mask), B))


@pytest.mark.parametrize("n,nd,topk_k,buckets", [
    (164_480, 4, 64, 1), (4 * 70_000, 4, 64, 1), (4_000, 2, 7, 1),
    (4 * 8, 4, 64, 1), (1 << 20, 4, 64, 2)])
def test_topk_wire_mirrors_jax(n, nd, topk_k, buckets):
    """build_wire("topk") as JAX's: one block of n / nd a chunk, k =
    min(block, ceil(topk_k / (nd * buckets))), u32 indices past 65,536;
    pack and bytes bit for bit."""
    w = build_wire("topk", topk_k=topk_k, n=n, nd=nd, num_buckets=buckets)
    jw = jbuild_wire("topk", topk_k=topk_k, n=n, nd=nd,
                     num_buckets=buckets)
    assert (w.k_per_block, w.block_size) == (jw.k_per_block, jw.block_size)
    assert w.wire_bytes(n) == jw.wire_bytes(n)
    assert str(w.index_dtype).split(".")[-1] == np.dtype(jw.index_dtype).name
    x = topk_chunks(nd, n // nd, seed=n, denormals=False)[:n]
    for a, b in zip(w.pack(_t(x)), jw.pack(jnp.asarray(x))):
        _equal(a.to(torch.int64) if a.dtype in (torch.uint16, torch.uint32)
               else a.float(), np.asarray(b).astype(
                   np.int64 if a.dtype in (torch.uint16, torch.uint32)
                   else np.float32))


def test_global_route_raises_on_budgets_and_kernel_limits():
    x = torch.zeros(4 * 1024)
    with pytest.raises(ValueError):           # no budgets on the route
        tp.ef_topk_fused(x, x.clone(), 1.0, 1.0, 8, 1024, k_send=4)
    cuda = torch.device("cuda")
    tp._check_shape(4 * 1024, 32, 1024, torch.float32, cuda,
                    global_route=True)
    for k, B, glob in ((33, 1024, True), (8, 1024, False), (8, 32, True)):
        with pytest.raises(ValueError):
            tp._check_shape(4 * 1024, k, B, torch.float32, cuda,
                            global_route=glob)
    assert tp.is_global(665_057_280) and not tp.is_global(512)
