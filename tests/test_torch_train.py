"""The slice end to end: the port's COCO-EF train step against JAX's real
main path (`build_train_setup` + `train_step` on a (data=4, model=1) mesh of
4 host devices, in a subprocess), gemma2-2b smoke config in float32, g = 32,
N = 4 coding ranks, d = 2, iid stragglers p = 0.1; on the sign wire, and on
the block top-K wire (k = 8, B = 256, f32 values), uniform and with the
per-rank budgets k = (8, 8, 4, 2).

JAX dumps its init params, batches, encode weights, host-side masks, each
rank's stage-1 gradient, and the loss, theta and e after each of 3 steps.
Its flat sizes (164,480 sign, 164,864 block top-K) are not multiples of the
Pallas tiles (256 and 2,048 elements), so JAX takes its jnp path, which
tests/test_backend_parity.py and tests/test_topk_select.py show is
bit-identical to the Pallas one (up to the signed zeros of ROADMAP C7).

The port draws JAX's batches itself (tokens included, through its copy of
XLA:CPU's exp), so the stage-1 comparisons could run from its own
batches; they keep injecting JAX's dumped batches, which are the same
bits, so a failure there points at stage 1 alone.

With one gloo process per coding rank (`build_train_setup(...,
group=grid)`, 4 processes started once for this module), 3 sign steps of
a 2-layer smoke config give the one-device setup's theta and error rows
bit for bit (both on one thread).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (G, LR, N, STEPS, _jax_run, _normal_blocks,
                          _port_setup, _state_dict, jax_batch)
from _torch_cases import one_thread_module  # noqa: F401 (autouse)
from _torch_gloo import TRAIN_STEPS, run_gloo, train_spec
from repro.core import coding as jcoding
from repro.core.collectives import SparseWire as JaxSparseWire
from repro.kernels import ref as jref
from repro.optim import optimizers as joptim
from repro_torch.configs import REGISTRY, ShapeCfg
from repro_torch.core import coding
from repro_torch.core.cocoef import CocoEFConfig, cocoef_update
from repro_torch.launch.train import TrainRun, build_train_setup
from repro_torch.optim import optimizers as optim


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    return _jax_run(tmp_path_factory)


SPARSE_RUNS = {"uniform": {"compressor": "block_topk"},
               "budgets": {"compressor": "block_topk",
                           "k_budgets": [8, 8, 4, 2]}}


@pytest.fixture(scope="module", params=list(SPARSE_RUNS))
def sparse_run(request, tmp_path_factory):
    """(TrainRun overrides, JAX's dump) of a block top-K run."""
    kw = SPARSE_RUNS[request.param]
    run_kw = {"compressor": kw["compressor"],
              "k_budgets": (tuple(kw["k_budgets"]) if "k_budgets" in kw
                            else None)}
    return run_kw, _jax_run(tmp_path_factory, kw)


def test_setup_matches_jax(ref_run):
    s = _port_setup()
    assert s.flat_pad == int(ref_run["flat_pad"]) == 164_480
    np.testing.assert_array_equal(s.W, ref_run["W"])       # bit-identical
    s.model.load_params(_state_dict(ref_run))
    np.testing.assert_array_equal(s.model.theta.numpy(), ref_run["theta0"])
    assert s.b_loc == ref_run["tokens0"].shape[1]
    assert ref_run["mask1"].tolist() == [0.0, 0.0, 1.0, 1.0]  # stragglers


def test_port_draws_jax_batches_and_masks(ref_run):
    """With the same seed (0) the port's batches and straggler masks are
    JAX's: tokens, weights and masks bit for bit."""
    s = _port_setup()
    for t in range(STEPS):
        toks, wts = s.make_batch(t)
        np.testing.assert_array_equal(wts.numpy(), ref_run[f"weights{t}"])
        np.testing.assert_array_equal(s.mask(t).numpy(), ref_run[f"mask{t}"])
        np.testing.assert_array_equal(toks.numpy(), ref_run[f"tokens{t}"])


def test_stage2_with_jax_gradients(ref_run):
    """(a) JAX's stage-1 gradients and JAX's state at the start of each
    step go into the port's stage 2.  Against JAX's sign-wire references on
    the same inputs: words identical, scales within 6 ulp (the group sum
    order, ROADMAP C3); ghat and e' within N * 6 ulp of the largest group
    scale, theta within that plus one rounding of theta - ghat, and ghat
    bitwise where every scale agrees.  Against JAX's mesh step, whose
    stage-1 gradients come from another jit of the same function, theta
    and e' within the sign-flip bound 2*N*(max scale)."""
    sign_stage2_checks(ref_run)


def sign_stage2_checks(ref_run):
    """The checks of test_stage2_with_jax_gradients on a JAX sign run."""
    cfg = CocoEFConfig(group_size=G)
    n = int(ref_run["flat_pad"])
    for t in range(STEPS):
        theta = torch.from_numpy(ref_run[f"theta{t}"].copy())
        e = (torch.zeros((N, n)) if t == 0 else
             torch.from_numpy(ref_run[f"e{t}"].copy()))
        e_jax_in = e.numpy().copy()
        g = ref_run[f"g{t}"]
        mask = ref_run[f"mask{t}"]
        payload = (torch.zeros((N, n // 32), dtype=torch.uint32),
                   torch.zeros((N, n // G)))
        ghat = cocoef_update(lambda i: torch.from_numpy(g[i].copy()), e,
                             torch.from_numpy(mask), LR, cfg, payload)
        theta_new = theta - ghat
        outs = [jref.ef_sign_fused_ref(jnp.asarray(g[i]),
                                       jnp.asarray(e_jax_in[i]),
                                       jnp.float32(LR), jnp.float32(mask[i]),
                                       G) for i in range(N)]
        jw = np.stack([np.asarray(o[0]) for o in outs])
        js = np.stack([np.asarray(o[1]) for o in outs])
        je = np.stack([np.asarray(o[3]) for o in outs])
        jghat = np.asarray(jref.sign_decode_reduce_scan(
            jnp.asarray(jw), jnp.asarray(js), jnp.asarray(mask), G))
        np.testing.assert_array_equal(payload[0].numpy(), jw)
        ds = np.abs(payload[1].numpy().view(np.int32).astype(np.int64)
                    - js.view(np.int32))
        assert ds.max() <= 6
        tol = 6 * np.spacing(np.float32(js.max())) * N
        assert np.abs(ghat.numpy() - jghat).max() <= tol
        assert np.abs(e.numpy() - je).max() <= tol
        jtheta = ref_run[f"theta{t}"] - jghat
        assert np.all(np.abs(theta_new.numpy() - jtheta)
                      <= tol + np.spacing(np.abs(jtheta)))
        if ds.max() == 0:
            np.testing.assert_array_equal(ghat.numpy(), jghat)
        flip = 2 * N * float(js.max()) + tol
        assert np.abs(theta_new.numpy()
                      - ref_run[f"theta{t + 1}"]).max() <= flip
        assert np.abs(e.numpy() - ref_run[f"e{t + 1}"]).max() <= flip


def test_end_to_end_matches_jax(ref_run):
    """(b) The port's whole step (its own stage 1 from the converted
    params, JAX's batches and masks) for 3 steps: loss within rtol 1e-4 per
    step; theta within steps * 2*N*gamma*(max group scale), the most that
    sign bits flipped by near-zero accumulators can move a coordinate, and
    almost every coordinate far closer."""
    end_to_end_checks(ref_run, _port_setup(), 2 * N)


def end_to_end_checks(ref, s, flip: float):
    """The port's step `s` for STEPS steps from JAX's params, batches and
    masks: loss within rtol 1e-4 per step; theta within steps * flip *
    (the payload's max scale) and under 1% of it off by more than 1e-6."""
    s.model.load_params(_state_dict(ref))
    e = torch.zeros((N, s.flat_pad))
    max_scale = 0.0
    for t in range(STEPS):
        m = s.train_step(s.model, e, jax_batch(ref, t), t,
                         masks=torch.from_numpy(ref[f"mask{t}"]))
        np.testing.assert_allclose(m["loss"].item(), ref[f"loss{t}"],
                                   rtol=1e-4)
        max_scale = max(max_scale, s.payload[-1].max().item())
        d = np.abs(s.model.theta.numpy() - ref[f"theta{t + 1}"])
        assert d.max() <= (t + 1) * flip * max_scale
        assert np.mean(d > 1e-6) < 0.01


def test_step_parity_cpu_against_cpu():
    """The card-versus-CPU check of chip_smoke.py and the gpu tests, run
    with the CPU on both sides: two separate setups give the same step bit
    for bit, so on the card any gap beyond its stated tolerances is the
    card's."""
    from repro_torch.launch.device_parity import step_parity
    out = step_parity("cpu")
    assert out["max_abs_dtheta"] == 0.0 and out["loss_cpu"] == \
        out["loss_device"]


def test_block_topk_setup_matches_jax(sparse_run):
    run_kw, ref = sparse_run
    s = _port_setup(**run_kw)
    assert s.flat_pad == int(ref["flat_pad"]) == 164_864
    assert s.cocoef_cfg.pad_multiple == 256
    np.testing.assert_array_equal(s.W, ref["W"])
    s.model.load_params(_state_dict(ref))
    np.testing.assert_array_equal(s.model.theta.numpy(), ref["theta0"])
    idx, val, scales = s.payload
    assert idx.shape == val.shape == (N, 164_864 // 256, 8)
    assert idx.dtype == torch.uint16 and scales.shape == (N, 644)


def test_block_topk_stage2_with_jax_gradients(sparse_run):
    """JAX's stage-1 gradients and JAX's state at the start of each step go
    into the port's stage 2.  Against JAX's jnp references on the same
    inputs, composed as JAX's cocoef_update does (the fused step, or with
    budgets pack, budget, unpack): payload, e' and ghat equal by value on
    every block with no denormal acc or e'; theta = theta - ghat there too.
    Against JAX's mesh step, whose stage-1 gradients come from another jit
    of the same function: theta and e' within N * (max block scale), the
    most that selections flipped at near-ties can move a coordinate."""
    run_kw, ref = sparse_run
    block_stage2_checks(ref, _port_setup(**run_kw))


def block_stage2_checks(ref, s):
    """The checks of test_block_topk_stage2_with_jax_gradients on a JAX
    block top-K run and the port's setup `s` of the same wire."""
    cfg, n = s.cocoef_cfg, s.flat_pad
    jw = JaxSparseWire(cfg.k_per_block, 256)
    for t in range(STEPS):
        theta = ref[f"theta{t}"]
        e_in = (np.zeros((N, n), np.float32) if t == 0 else ref[f"e{t}"])
        e = torch.from_numpy(e_in.copy())
        g, mask = ref[f"g{t}"], ref[f"mask{t}"]
        payload = tuple(torch.zeros_like(p) for p in s.payload)
        ghat = cocoef_update(lambda i: torch.from_numpy(g[i].copy()), e,
                             torch.from_numpy(mask), LR, cfg,
                             payload).numpy()
        jp, je = [], []
        for i in range(N):
            gi, ei = jnp.asarray(g[i]), jnp.asarray(e_in[i])
            if jw.has_rank_budgets():
                acc = jref.mul_add(jnp.float32(LR), gi, ei)
                p = jw.apply_rank_budget(jw.pack(acc), i)
                en = jnp.where(mask[i] > 0, acc - jw.unpack(p), ei)
            else:
                idx, val, sc, _, en = jref.ef_topk_fused_ref(
                    gi, ei, jnp.float32(LR), jnp.float32(mask[i]), 8, 256)
                p = (idx, val, sc)
            jp.append([np.asarray(x).astype(np.float32) for x in p])
            je.append(np.asarray(en))
        je = np.stack(je)
        acc = (np.float32(LR) * g + e_in).astype(np.float32)    # IEEE
        ok = _normal_blocks(acc, e.numpy())
        assert ok.mean() > 0.99
        for j in range(3):
            want = np.stack([p[j] for p in jp])
            got = payload[j].float().numpy()
            np.testing.assert_array_equal(got[ok], want[ok])
        okx = np.repeat(ok, 256, axis=1)
        np.testing.assert_array_equal(e.numpy()[okx], je[okx])
        jghat = np.asarray(jref.topk_decode_reduce_scan(
            *(jnp.asarray(np.stack([p[j] for p in jp]).astype(
                np.int32 if j == 0 else np.float32)) for j in range(3)),
            jnp.asarray(mask), 256))
        col = okx.all(0)
        np.testing.assert_array_equal(ghat[col], jghat[col])
        np.testing.assert_array_equal((theta - ghat)[col],
                                      (theta - jghat)[col])
        flip = N * float(payload[2].max()) + 1e-6
        assert np.abs(theta - ghat - ref[f"theta{t + 1}"]).max() <= flip
        assert np.abs(e.numpy() - ref[f"e{t + 1}"]).max() <= flip


def test_block_topk_end_to_end_matches_jax(sparse_run):
    """The port's whole step (its own stage 1 from the converted params,
    JAX's batches and masks) for 3 steps: loss within rtol 1e-4 per step;
    theta within steps * N * (max block scale), the most that selections
    flipped at near-ties can move a coordinate, and almost every
    coordinate far closer."""
    run_kw, ref = sparse_run
    end_to_end_checks(ref, _port_setup(**run_kw), N)


@pytest.mark.parametrize("compressor,k_budgets", [
    ("block_topk", None), ("block_topk", (8, 8, 4, 2))])
def test_block_topk_step_parity_cpu_against_cpu(compressor, k_budgets):
    from repro_torch.launch.device_parity import step_parity
    out = step_parity("cpu", compressor=compressor, k_budgets=k_budgets)
    assert out["max_abs_dtheta"] == 0.0 and out["loss_cpu"] == \
        out["loss_device"]


def test_train_run_validates_the_wire_overrides():
    spec = REGISTRY["gemma2-2b"]
    with pytest.raises(ValueError):
        TrainRun(k_budgets=(8, 0, 4, 2))
    with pytest.raises(ValueError):
        TrainRun(k_budgets=())
    with pytest.raises(ValueError):          # budgets need block_topk
        TrainRun(k_budgets=(8, 8, 4, 2)).coding_config(spec.coding, 4)
    with pytest.raises(ValueError):          # one budget per rank
        TrainRun(compressor="block_topk",
                 k_budgets=(8, 4)).coding_config(spec.coding, 4)
    with pytest.raises(ValueError):          # no such compressor
        TrainRun(compressor="randk").coding_config(spec.coding, 4)
    cfg = TrainRun(compressor="block_topk", k_budgets=(8, 8, 4, 2)
                   ).coding_config(spec.coding, 4)
    assert cfg.k_per_block == (8, 8, 4, 2) and cfg.pad_multiple == 512


def test_encode_weights_and_allocation_match_jax():
    for p in (0.0, 0.1, 0.3):
        a = coding.cyclic_allocation(4, 4, 2)
        ja = jcoding.cyclic_allocation(4, 4, 2)
        np.testing.assert_array_equal(a.S, ja.S)
        np.testing.assert_array_equal(
            coding.encode_weights(a, p=p),
            np.asarray(jcoding.encode_weights(ja, p)))
    rates = [0.9, 0.8, 0.95, 0.7]
    np.testing.assert_array_equal(
        coding.encode_weights(a, rates=rates),
        np.asarray(jcoding.encode_weights(ja, rates=rates)))


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_optimizers_match_jax(kind):
    """In-place update against JAX's functional one, with decoupled decay;
    within 1 ulp-level rtol 1e-6 (sqrt and pow may round differently)."""
    rng = np.random.default_rng(0)
    n = 1024
    p0 = rng.standard_normal(n).astype(np.float32)
    gh = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    jcfg = joptim.OptimizerConfig(kind=kind, weight_decay=0.01)
    pcfg = optim.OptimizerConfig(kind=kind, weight_decay=0.01)
    jstate = joptim.init_opt_state(jcfg, n)
    pstate = optim.init_opt_state(pcfg, n, device="cpu")
    jp, pp = jnp.asarray(p0), torch.from_numpy(p0.copy())
    for step in range(3):
        gamma = np.float32(1e-2)
        jp, jstate = joptim.apply_update(jcfg, jp, jnp.asarray(gh), jstate,
                                         jnp.int32(step), jnp.float32(gamma))
        optim.apply_update(pcfg, pp, torch.from_numpy(gh), pstate, step,
                           gamma)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("kind,warmup,total", [("constant", 0, None),
                                               ("rsqrt", 3, None),
                                               ("cosine", 2, 10)])
def test_lr_schedule_matches_jax(kind, warmup, total):
    jf = joptim.lr_schedule(kind, 5e-3, warmup, total)
    pf = optim.lr_schedule(kind, 5e-3, warmup, total)
    for step in range(12):
        np.testing.assert_allclose(pf(step).item(), float(jf(step)),
                                   rtol=1e-6)
    with pytest.raises(ValueError):
        optim.lr_schedule("cosine", 1.0)


@pytest.fixture(scope="module")
def gloo_train(tmp_path_factory):
    return run_gloo("train", tmp_path_factory.mktemp("gloo_train"))


def test_group_train_equals_one_device(gloo_train):
    """4 gloo processes, each one coding rank with its own coded rows, its
    own error row, one backward pass and the group update: theta on every
    rank equals the one-device setup's after each of 3 sign steps, bit for
    bit, and each rank's error row is the one-device row."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = build_train_setup(train_spec(), ShapeCfg("train", 32, 8),
                              TrainRun(base_lr=5e-3), smoke=True, n_code=N,
                              device="cpu")
        assert s.model.cfg.num_layers == 2
        e = s.init_state()
        for rank in gloo_train:
            assert torch.equal(rank["theta0"], s.model.theta)
        for t in range(TRAIN_STEPS):
            m = s.train_step(s.model, e, s.make_batch(t), t)
            for i, rank in enumerate(gloo_train):
                assert torch.equal(rank[f"theta{t + 1}"].view(torch.int32),
                                   s.model.theta.view(torch.int32)), (t, i)
                assert rank[f"loss{t}"] == m["losses"][i].item()
        assert s.mask(1).tolist() != [1.0] * N          # a straggler step
        for i, rank in enumerate(gloo_train):
            assert torch.equal(rank["e"].view(torch.int32),
                               e[i].view(torch.int32))
    finally:
        torch.set_num_threads(threads)


def test_train_run_takes_the_bucket_and_phase2_knobs():
    run = TrainRun(num_buckets=2, bucket_schedule="serial",
                   phase2_dtype="bfloat16", phase2_sign=True)
    cfg = run.coding_config(REGISTRY["gemma2-2b"].coding, N)
    assert (cfg.num_buckets, cfg.bucket_schedule, cfg.phase2_dtype,
            cfg.phase2_sign) == (2, "serial", "bfloat16", True)
    for bad in ({"num_buckets": 0}, {"bucket_schedule": "eager"},
                {"phase2_dtype": "float16"}):
        with pytest.raises(ValueError):
            TrainRun(**bad)
    s = build_train_setup(train_spec(), ShapeCfg("train", 32, 8),
                          TrainRun(num_buckets=2), smoke=True, n_code=N,
                          device="cpu")
    assert s.flat_pad % (N * 32 * 2) == 0
    words, scales = s.payload
    assert words.shape == (2, N, s.flat_pad // 64)
    assert scales.shape == (2, N, s.flat_pad // 64)
