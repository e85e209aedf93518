"""The COCO baseline (mode="coco": biased compression, no error feedback)
and its pack-only kernels, against the JAX package.

Kernels (plain versions, on the CPU):
  - `sign_pack` against JAX's Pallas `sign_pack` in interpret mode: words
    exact, group scales within XLA_ULP = 6 ulp (the group sum order,
    ROADMAP C3).
  - `block_topk` against JAX's Pallas `block_topk` in interpret mode, bit
    for bit (kept values with their sign, +0.0 elsewhere), f32 and bf16,
    on random blocks and the adversarial rows of tests/test_topk_select.py.
    XLA:CPU flushes denormals (ROADMAP C6), so every |x| is >= 2**-126 or
    zero.  JAX's `ref.block_topk_ref` keeps another set on ties (ROADMAP
    C8), pinned by `test_block_topk_keeps_lax_top_k_set_not_jax_ref`.

The step: the port's train step in coco mode against JAX's real
`TrainRun(mode="coco")` step (`build_train_setup` + `train_step` on a
(data=4, model=1) mesh of 4 host devices, in a subprocess; the harness of
tests/_torch_cases.py), gemma2-2b smoke config in float32, g = 32, N = 4,
on the sign wire, the block top-K wire (k = 8, B = 256, f32 values) and
the block top-K wire with the per-rank budgets k = (8, 8, 4, 2).
Tolerances:
  - stage 2 on JAX's dumped gradients: acc = gamma*g is one f32 rounding
    on both sides.  Sign: words exact, scales within XLA_ULP, ghat within
    N * XLA_ULP ulp of the largest scale and bit for bit wherever every
    scale agrees.  Block top-K: payload and ghat bit for bit on every block
    with no denormal acc (C6).  e exactly JAX's, which is its zero start.
  - 3 steps of the whole step (the port's own stage 1): loss within rtol
    1e-4 per step; theta within steps * TOL * N * (max scale), the most
    that decisions flipped at near-ties can move a coordinate (TOL = 2 on
    the sign wire: a flipped sign bit moves c by 2 * scale; TOL = 1 on the
    block top-K wire: a swapped selection moves c by at most the block
    scale), and fewer than 1% of the coordinates more than 1e-6 apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (G, LR, N, STEPS, _jax_run, _normal_blocks,
                          _port_setup, _state_dict, ef_inputs, topk_rows,
                          ulp_diff)
from _torch_cases import one_thread_module  # noqa: F401 (autouse)
from repro.core.collectives import SparseWire as JaxSparseWire
from repro.kernels import ref as jref, sign_pack as jsp, topk_block as jtb
from repro_torch.core.cocoef import CocoEFConfig, cocoef_update
from repro_torch.core.collectives import SignWire
from repro_torch.kernels import ops, ref, sign_pack as sp, topk_pack as tp
from repro_torch.launch.train import TrainRun
from repro_torch.optim import optimizers as optim

XLA_ULP = 6


def _t(a):
    return torch.from_numpy(np.array(a))


# --- kernels ---------------------------------------------------------------

@pytest.mark.parametrize("group_size", [32, 128, 512])
def test_sign_pack_matches_jax_pallas(group_size):
    """Groups of +0, -0.0, the smallest normals, all-equal, then groups of
    widely varying scale."""
    n = 8 * group_size * 6
    x, _ = ef_inputs(n, group_size, seed=group_size, denormals=False)
    before = dict(sp.launches)
    words, scales = ops.sign_pack(_t(x), group_size)
    assert sp.launches == before                   # plain version: no count
    pw, ps = jsp.sign_pack(jnp.asarray(x), group_size, interpret=True)
    np.testing.assert_array_equal(words.numpy(), np.asarray(pw).reshape(-1))
    ps = np.asarray(ps).reshape(-1)
    assert ulp_diff(scales.numpy(), ps).max() <= XLA_ULP
    assert np.all(words.numpy()[group_size // 32:group_size // 16]
                  == 0xFFFFFFFF)                   # -0.0 packs as +
    w0, s0 = ref.sign_pack_ref(_t(x), group_size)
    assert torch.equal(words, w0) and torch.equal(scales, s0)
    out = (torch.zeros_like(words), torch.zeros_like(scales))
    got = SignWire(group_size).fused_pack(_t(x), out=out)
    assert got[0] is out[0] and torch.equal(out[0], words)
    assert torch.equal(out[1], scales)


@pytest.mark.parametrize("block_size", [128, 256])
@pytest.mark.parametrize("k", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_topk_matches_jax_pallas(block_size, k, dtype):
    x = jnp.asarray(topk_rows(block_size, seed=block_size + k)).astype(
        dtype)
    want = np.asarray(jtb.block_topk(x, k, block_size, interpret=True)
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        ref.wire_dtype(dtype))
    before = dict(tp.launches)
    got = ops.block_topk(xt, k, block_size)
    assert tp.launches == before
    assert got.dtype == xt.dtype and got.shape == xt.shape
    got = got.float().numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    kept = (got.reshape(-1, block_size) != 0).sum(-1)
    assert kept.max() <= k
    # in place (out = x), as the wrapper allows
    xi = xt.clone()
    assert tp.block_topk(xi, k, block_size, out=xi) is xi
    np.testing.assert_array_equal(xi.float().numpy().view(np.int32),
                                  want.view(np.int32))


def test_block_topk_keeps_lax_top_k_set_not_jax_ref():
    """ROADMAP C8: |x| = [3, 3, 5, 0.5, ...], k = 2.  The Pallas kernel and
    the port keep positions {0, 2} (`lax.top_k`'s set); JAX's
    `ref.block_topk_ref` keeps the first two entries >= 3, {0, 1}."""
    B, k = 128, 2
    x = np.full(B * 8, 0.25, np.float32)
    x[:4] = [3.0, -3.0, 5.0, 0.5]
    port = ops.block_topk(_t(x), k, B).numpy()
    pallas = np.asarray(jtb.block_topk(jnp.asarray(x), k, B, interpret=True))
    jax_ref = np.asarray(jref.block_topk_ref(jnp.asarray(x), k, B))
    assert np.flatnonzero(port[:B]).tolist() == [0, 2]
    np.testing.assert_array_equal(port, pallas)
    assert np.flatnonzero(jax_ref[:B]).tolist() == [0, 1]
    assert not np.array_equal(port, jax_ref)


def test_block_topk_bad_inputs_raise():
    x = torch.zeros(8 * 128)
    with pytest.raises(ValueError):
        ops.block_topk(x, 0, 128)
    with pytest.raises(ValueError):
        ops.block_topk(x[:100], 8, 128)
    with pytest.raises(ValueError):
        ops.block_topk(x, 8, 128, out=torch.zeros(5))
    with pytest.raises(TypeError):
        ops.block_topk(x, 8, 128, out=x.to(torch.bfloat16))
    cuda = torch.device("cuda")
    for n, k, B, dt in ((1024, 8, 64, torch.float32),
                        (1024, 33, 128, torch.float32),
                        (1024, 8, 128, torch.float16)):
        with pytest.raises(ValueError):
            tp._check_shape(n, k, B, dt, cuda, tp.BLOCK_TOPK_SIZES)
    tp._check_shape(1024, 32, 128, torch.bfloat16, cuda, tp.BLOCK_TOPK_SIZES)
    with pytest.raises(ValueError):                    # g = 48
        ops.sign_pack(torch.zeros(8 * 48), 48)
    with pytest.raises(TypeError):
        ops.sign_pack(torch.zeros(8 * 32, dtype=torch.float64), 32)


# --- the coco step ---------------------------------------------------------

COCO_RUNS = {"sign": {"mode": "coco"},
             "block_topk": {"mode": "coco", "compressor": "block_topk"},
             "budgets": {"mode": "coco", "compressor": "block_topk",
                         "k_budgets": [8, 8, 4, 2]}}


@pytest.fixture(scope="module", params=list(COCO_RUNS))
def coco_run(request, tmp_path_factory):
    """(name, TrainRun keywords, JAX's dump) of a coco run."""
    kw = COCO_RUNS[request.param]
    run_kw = dict(kw)
    if "k_budgets" in kw:
        run_kw["k_budgets"] = tuple(kw["k_budgets"])
    return request.param, run_kw, _jax_run(tmp_path_factory, kw)


def test_coco_setup_matches_jax(coco_run):
    name, run_kw, ref_ = coco_run
    s = _port_setup(**run_kw)
    assert s.cocoef_cfg.mode == "coco"
    assert s.flat_pad == int(ref_["flat_pad"]) == \
        (164_480 if name == "sign" else 164_864)
    np.testing.assert_array_equal(s.W, ref_["W"])
    s.model.load_params(_state_dict(ref_))
    np.testing.assert_array_equal(s.model.theta.numpy(), ref_["theta0"])
    for t in range(1, STEPS + 1):          # JAX's coco step leaves e alone
        assert not ref_[f"e{t}"].any()


def _jax_stage2(name, cfg, g, mask):
    """JAX's coco stage 2 on the same gradients from its jnp references,
    composed as `repro/core/cocoef.py:286-296`: acc = gamma*g, payload =
    budget_i(pack(acc)), the sender-order decode.  Returns (payload leaves
    stacked over ranks as numpy, ghat, acc)."""
    acc = [jnp.float32(LR) * jnp.asarray(g[i]) for i in range(N)]
    if name == "sign":
        p = [jref.sign_pack_ref(a, G) for a in acc]
        leaves = [np.stack([np.asarray(x[j]) for x in p]) for j in range(2)]
        ghat = jref.sign_decode_reduce_scan(
            jnp.asarray(leaves[0]), jnp.asarray(leaves[1]),
            jnp.asarray(mask), G)
    else:
        jw = JaxSparseWire(cfg.k_per_block, 256)
        p = [jw.apply_rank_budget(jw.pack(a), i) for i, a in enumerate(acc)]
        leaves = [np.stack([np.asarray(x[j]).astype(np.float32) for x in p])
                  for j in range(3)]
        ghat = jref.topk_decode_reduce_scan(
            jnp.asarray(leaves[0].astype(np.int32)), jnp.asarray(leaves[1]),
            jnp.asarray(leaves[2]), jnp.asarray(mask), 256)
    return leaves, np.asarray(ghat), np.stack([np.asarray(a) for a in acc])


def test_coco_stage2_with_jax_gradients(coco_run):
    """JAX's stage-1 gradients and theta at the start of each step go into
    the port's coco stage 2 (see the module docstring for the tolerances);
    against JAX's mesh step, theta within TOL * N * (max scale)."""
    name, run_kw, ref_ = coco_run
    s = _port_setup(**run_kw)
    cfg, n = s.cocoef_cfg, s.flat_pad
    tol_flip = 2.0 if name == "sign" else 1.0
    for t in range(STEPS):
        theta = ref_[f"theta{t}"]
        g, mask = ref_[f"g{t}"], ref_[f"mask{t}"]
        e = torch.from_numpy(
            np.random.default_rng(t).standard_normal((N, n))
            .astype(np.float32))
        e_bits = e.numpy().view(np.int32).copy()
        payload = tuple(torch.zeros_like(p) for p in s.payload)
        ghat = cocoef_update(lambda i: torch.from_numpy(g[i].copy()), e,
                             torch.from_numpy(mask), LR, cfg,
                             payload).numpy()
        np.testing.assert_array_equal(e.numpy().view(np.int32), e_bits)
        want, jghat, acc = _jax_stage2(name, cfg, g, mask)
        if name == "sign":
            np.testing.assert_array_equal(payload[0].numpy(), want[0])
            du = ulp_diff(payload[1].numpy(), want[1])
            assert du.max() <= XLA_ULP
            tol = XLA_ULP * np.spacing(np.float32(want[1].max())) * N
            assert np.abs(ghat - jghat).max() <= tol
            if du.max() == 0:
                np.testing.assert_array_equal(ghat, jghat)
            scale = float(want[1].max())
        else:
            ok = _normal_blocks(acc, np.zeros_like(acc))
            assert ok.mean() > 0.99
            for j in range(3):
                got = payload[j].float().numpy()
                np.testing.assert_array_equal(got[ok], want[j][ok])
            col = np.repeat(ok, 256, axis=1).all(0)
            np.testing.assert_array_equal(ghat[col].view(np.int32),
                                          jghat[col].view(np.int32))
            scale = float(want[2].max())
        assert np.abs(theta - ghat - ref_[f"theta{t + 1}"]).max() <= \
            tol_flip * N * scale + 1e-6


def test_coco_end_to_end_matches_jax(coco_run):
    """The port's whole coco step (its own stage 1 from the converted
    params, JAX's batches and masks) for 3 steps; e stays exactly JAX's."""
    name, run_kw, ref_ = coco_run
    s = _port_setup(**run_kw)
    s.model.load_params(_state_dict(ref_))
    e = torch.zeros((N, s.flat_pad))
    tol_flip = 2.0 if name == "sign" else 1.0
    max_scale = 0.0
    for t in range(STEPS):
        batch = (torch.from_numpy(ref_[f"tokens{t}"]).long(),
                 torch.from_numpy(ref_[f"weights{t}"]))
        m = s.train_step(s.model, e, batch, t,
                         masks=torch.from_numpy(ref_[f"mask{t}"]))
        np.testing.assert_allclose(m["loss"].item(), ref_[f"loss{t}"],
                                   rtol=1e-4)
        max_scale = max(max_scale, s.payload[-1].max().item())
        d = np.abs(s.model.theta.numpy() - ref_[f"theta{t + 1}"])
        assert d.max() <= (t + 1) * tol_flip * N * max_scale
        assert np.mean(d > 1e-6) < 0.01
        np.testing.assert_array_equal(e.numpy().view(np.int32),
                                      ref_[f"e{t + 1}"].view(np.int32))


@pytest.mark.parametrize("compressor,k_budgets", [
    ("sign", None), ("block_topk", None), ("block_topk", (8, 8, 4, 2))])
def test_coco_step_parity_cpu_against_cpu(compressor, k_budgets):
    from repro_torch.launch.device_parity import step_parity
    out = step_parity("cpu", compressor=compressor, k_budgets=k_budgets,
                      mode="coco")
    assert out["max_abs_dtheta"] == 0.0 and out["loss_cpu"] == \
        out["loss_device"]


def test_modes_are_validated():
    assert TrainRun().mode == CocoEFConfig().mode == "cocoef"
    assert TrainRun(mode="dense").mode == CocoEFConfig(mode="dense").mode
    for bad in ("ef21", "Dense"):
        with pytest.raises(ValueError, match="unknown mode"):
            TrainRun(mode=bad)
        with pytest.raises(ValueError):
            CocoEFConfig(mode=bad)
    from repro_torch.configs import REGISTRY
    cfg = TrainRun(mode="coco", compressor="block_topk",
                   k_budgets=(8, 8, 4, 2)).coding_config(
                       REGISTRY["gemma2-2b"].coding, 4)
    assert cfg.mode == "coco" and cfg.k_per_block == (8, 8, 4, 2)


def test_init_opt_state_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU:
    without a card the default raises instead of running on the CPU."""
    cfg = optim.OptimizerConfig(kind="momentum")
    (m,) = optim.init_opt_state(cfg, 8, device="cpu")
    assert m.device.type == "cpu" and not m.any()
    if torch.cuda.is_available():
        assert optim.init_opt_state(cfg, 8)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            optim.init_opt_state(cfg, 8)
