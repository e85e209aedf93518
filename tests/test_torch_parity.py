"""The port's parity gate of Algorithm 1 and its coded collective across
processes, buckets and phase 2 (`repro_torch.launch.parity`,
`core.cocoef`, `core.collectives`, `launch.mesh`).

  - `run_parity` (the (N, D) reference loop against the coded step, JAX's
    parity sizes: linreg dim 1024, N = 4, d = 2, p = 0.25, two shards,
    T = 20) for sign, block top-K and identity x num_buckets {1, 2} x
    {serial, pipelined}: bit for bit, with every rank on one device and
    with one gloo process per rank on a 1-D grid (4,).
  - Stage 2 alone on seeded inputs (`_torch_cases.MESH_CASES`) against
    JAX's mesh `cocoef_update` (a shard_map over 4 host devices, all cases
    in one subprocess): buckets in both schedules, phase 2 in bf16 and
    re-packed on the sign wire, coco and dense, bit for bit, on one
    device and on the gloo grid.  The inputs make every comparison exact
    by construction where JAX's arithmetic cannot be reproduced: gamma =
    0.5 (gamma*g exact, so XLA's FMA contraction, ROADMAP C12, changes
    nothing) and, on the sign wire, integer-valued accumulators (every
    group mean exact in any order, so no C3 allowance).
  - The 2 x 2 grid (coding axes ("pod", "data")): the gloo group sums
    each chunk's senders, then the outer group, as JAX does, which is
    another association than the one-device rank order; it must equal
    JAX's 2 x 2 mesh bit for bit (jax 0.9.0 runs this shard_map; its
    reference-side TypeError hits only `check=True`), and on the float
    block top-K case it must differ from the flat order somewhere, so the
    check can tell the two orders apart.
  - Phase 2's semantics on one device (bf16: f32(bf16(ghat)); sign:
    unpack(pack(ghat))) and the all-straggler step (ghat = 0, e
    untouched), on one device and on the grid.
The gloo processes start once for the module (one fixture)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_cases import MESH_CASES, MESH_GAMMA, MESH_MASK, mesh_inputs
from _torch_gloo import PARITY_CASES, run_gloo
from _torch_wire_cases import jax_mesh_cases
from repro_torch.core.cocoef import CocoEFConfig, cocoef_update
from repro_torch.core.collectives import SignWire
from repro_torch.kernels import ref
from repro_torch.launch.parity import (PARITY_COMPRESSORS, assert_parity,
                                      run_parity)
from repro_torch.launch.train import _payload_buffers

ONE_D = [n for n, (axes, _, _) in MESH_CASES.items() if len(axes) == 1]
GRID = [n for n, (axes, _, _) in MESH_CASES.items() if len(axes) == 2]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Each of the 4 gloo ranks' results of the parity job."""
    return run_gloo("parity", tmp_path_factory.mktemp("gloo_parity"))


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    return jax_mesh_cases(tmp_path_factory, list(MESH_CASES))


def _bits(t):
    t = torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) \
        else t
    return t.contiguous().view(torch.int32)


def _equal(a, b):
    assert torch.equal(_bits(a), _bits(b))


def one_device(name, mask=MESH_MASK):
    """The one-device `cocoef_update` of a MESH_CASES case: (ghat, e')."""
    _, kw, kind = MESH_CASES[name]
    g, e = (torch.from_numpy(x) for x in mesh_inputs(kind))
    cfg = CocoEFConfig(group_size=32, **kw)
    payload = _payload_buffers(cfg, 4, g.shape[1], "cpu")
    ghat = cocoef_update(lambda i: g[i].clone(), e, torch.tensor(mask),
                         MESH_GAMMA, cfg, payload)
    return ghat.clone(), e


@pytest.mark.parametrize("compressor,buckets,schedule", PARITY_CASES)
def test_run_parity_one_device(compressor, buckets, schedule):
    torch.set_num_threads(1)
    r = run_parity(compressor, num_buckets=buckets, bucket_schedule=schedule,
                   device="cpu")
    assert_parity(r)
    assert r["T"] == 20 and r["dim"] == 1024 and r["loss_ref"] < \
        r["loss_start"]


@pytest.mark.parametrize("compressor,buckets,schedule", PARITY_CASES)
def test_run_parity_gloo_grid(gloo, compressor, buckets, schedule):
    """The same gate with one gloo process per coding rank: theta and each
    rank's own error row bit for bit on every rank."""
    for rank in gloo:
        exact, div = rank[f"parity/{compressor}/{buckets}/{schedule}"]
        assert exact, div


def test_run_parity_refuses_dynamic_state():
    """dynamic_state (the elastic coding plane's third trajectory, W from
    a pinned `CodingPlan` every step) is ported: it runs and is bit-exact
    on every wire; what parity still refuses is global top-K."""
    for comp in PARITY_COMPRESSORS:
        rep = run_parity(comp, T=6, device="cpu", dynamic_state=True)
        assert rep["dynamic_state"] and rep["bitexact"], rep
    with pytest.raises(ValueError):
        run_parity("topk", T=1, device="cpu")


@pytest.mark.parametrize("name", ONE_D)
def test_one_device_stage2_matches_jax_mesh(jax_mesh, name):
    """Buckets (both schedules), phase 2 (bf16, sign), coco and dense on
    one device against JAX's 1-D mesh step, bit for bit."""
    ghat, e = one_device(name)
    jg, je = jax_mesh[name]
    for i in range(4):
        _equal(ghat, jg[i])
    if MESH_CASES[name][1].get("mode", "cocoef") == "cocoef":
        _equal(e, je)


@pytest.mark.parametrize("name", ONE_D)
def test_gloo_stage2_matches_one_device(gloo, name):
    """The group form on the 1-D gloo grid is the one-device form bit for
    bit (so JAX's too, by the test above)."""
    ghat, e = one_device(name)
    cocoef = MESH_CASES[name][1].get("mode", "cocoef") == "cocoef"
    for rank, res in enumerate(gloo):
        gg, ge = res[f"mesh/{name}"]
        _equal(gg, ghat)
        if cocoef:
            _equal(ge, e[rank])


@pytest.mark.parametrize("name", GRID)
def test_grid_2x2_matches_jax_mesh(gloo, jax_mesh, name):
    """On the 2 x 2 grid the gloo group gives JAX's 2 x 2 mesh step bit for
    bit (the hierarchical order: each chunk's senders, then the outer
    group; dense mode: the outer group, then the chunk)."""
    jg, je = jax_mesh[name]
    cocoef = MESH_CASES[name][1].get("mode", "cocoef") == "cocoef"
    for rank, res in enumerate(gloo):
        gg, ge = res[f"mesh/{name}"]
        _equal(gg, jg[rank])
        if cocoef:
            _equal(ge, je[rank])
    if name == "grid_block_b2":           # not the flat rank order
        flat, _ = one_device("block_b2_pipelined")
        assert not torch.equal(_bits(gloo[0][f"mesh/{name}"][0]),
                               _bits(flat))


def test_phase2_semantics_on_one_device():
    """Phase 2 returns what the receivers of `_phase2_gather` get: the f32
    aggregate rounded through bf16, or sign-packed with group_size and
    unpacked (the pack is the sign_pack plain version: words exact, the
    group mean in the kernels' order)."""
    base, _ = one_device("sign_b2_pipelined")
    bf, _ = one_device("sign_phase2_bf16")
    _equal(bf, base.to(torch.bfloat16).float())
    sg, _ = one_device("sign_phase2_sign")
    w = SignWire(32)
    _equal(sg, w.unpack(w.pack(base)))
    assert not torch.equal(sg, base)


def test_all_straggler_step(gloo):
    """Every rank straggles: ghat = 0 and every error vector keeps its bits,
    on one device and on the gloo grid (the broadcast still runs)."""
    g, e = (torch.from_numpy(x) for x in mesh_inputs("float"))
    e0 = e.clone()
    cfg = CocoEFConfig(group_size=32, num_buckets=2)
    ghat = cocoef_update(lambda i: g[i].clone(), e, torch.zeros(4),
                         MESH_GAMMA, cfg, _payload_buffers(cfg, 4, g.shape[1],
                                                           "cpu"))
    assert torch.equal(ghat, torch.zeros_like(ghat))
    _equal(e, e0)
    for rank, res in enumerate(gloo):
        gg, before, after = res["straggle"]
        assert torch.equal(gg, torch.zeros_like(gg))
        _equal(after, before)
        _equal(before, e0[rank])


def test_config_validates_the_knobs():
    with pytest.raises(ValueError):
        CocoEFConfig(bucket_schedule="eager")
    with pytest.raises(ValueError):
        CocoEFConfig(num_buckets=0)
    with pytest.raises(ValueError):
        CocoEFConfig(phase2_dtype="float16")
    cfg = CocoEFConfig(num_buckets=2, compressor="topk", topk_k=64)
    assert cfg.wire_format(4096, 4).k_per_block == 8    # ceil(64 / (4*2))
    assert dataclasses.replace(cfg, num_buckets=1).wire_format(
        4096, 4).k_per_block == 16
    assert ref.wire_dtype(cfg.collective().phase2_dtype) == torch.float32
