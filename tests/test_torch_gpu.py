"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where no CUDA device is present (decided inside the
`cuda` fixture, never at import).  This file imports no JAX, so it also
runs on a machine without it:
    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
(--noconftest: tests/conftest.py imports JAX)."""
import numpy as np
import pytest
import torch

from _torch_cases import (GAMMA, check_ef_outputs, ef_inputs, flash_inputs,
                          topk_inputs, topk_payload, topk_rows)
from repro_torch.kernels import flash_attention as fa, ref, \
    sign_pack as sp, topk_pack as tp
from repro_torch.kernels.common import flash_routes

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _np(t):
    return None if t is None else t.cpu().numpy()


@pytest.mark.parametrize("group_size", sp.SUPPORTED_GROUP_SIZES)
@pytest.mark.parametrize("mask", [0.0, 1.0])
def test_ef_sign_fused_kernel_matches_plain(cuda, group_size, mask):
    n = group_size * 8 * 37
    g, e = ef_inputs(n, group_size, seed=group_size)
    gt, et = torch.from_numpy(g).to(cuda), torch.from_numpy(e).to(cuda)
    before = sp.launches["ef_sign_fused"]
    got = sp.ef_sign_fused(gt, et, float(GAMMA), mask, group_size,
                           want_c=True)
    torch.cuda.synchronize()
    assert sp.launches["ef_sign_fused"] == before + 1
    want = ref.ef_sign_fused_ref(gt, et, float(GAMMA), mask, group_size)
    check_ef_outputs(tuple(map(_np, want)), tuple(map(_np, got)),
                     group_size, max_ulp=0)            # same sum order
    # in place (e_new aliases e), as the train step runs it
    words, scales, _, e_new = got
    e2 = et.clone()
    w2, s2, _, _ = sp.ef_sign_fused(gt, e2, float(GAMMA), mask, group_size,
                                    out=(torch.empty_like(words),
                                         torch.empty_like(scales), e2))
    torch.cuda.synchronize()
    assert torch.equal(w2, words) and torch.equal(s2, scales)
    assert torch.equal(e2.view(torch.int32), e_new.view(torch.int32))


@pytest.mark.parametrize("group_size", [32, 512])
def test_sign_decode_reduce_kernel_matches_plain(cuda, group_size):
    rng = np.random.default_rng(1)
    N, n = 5, group_size * 8 * 29
    words = torch.from_numpy(rng.integers(0, 2**32, (N, n // 32),
                                          dtype=np.uint32)).to(cuda)
    scales = torch.from_numpy(np.abs(rng.standard_normal(
        (N, n // group_size))).astype(np.float32)).to(cuda)
    scales[0, :3] = 0.0
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0], device=cuda)
    got = sp.sign_decode_reduce(words, scales, mask, group_size)
    torch.cuda.synchronize()
    want = ref.sign_decode_reduce_ref(words, scales, mask, group_size)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_wrappers_raise_instead_of_falling_back(cuda):
    g = torch.zeros(96 * 8, device=cuda)
    with pytest.raises(ValueError):                 # no kernel for g=96
        sp.ef_sign_fused(g, g.clone(), 1.0, 1.0, 96)
    with pytest.raises(TypeError):
        sp.ef_sign_fused(g.double(), g.double(), 1.0, 1.0, 32)
    with pytest.raises(ValueError):
        sp.ef_sign_fused(g, g.cpu(), 1.0, 1.0, 32)


def test_train_step_cuda_matches_cpu(cuda):
    """The train step on the card against the CPU (`launch/device_parity.py`):
    full step within the stated tolerances, stage 2 on injected gradients
    bit for bit."""
    from repro_torch.launch.device_parity import step_parity
    step_parity("cuda")


@pytest.mark.parametrize("k_budgets", [None, (8, 8, 4, 2)])
def test_block_topk_train_step_cuda_matches_cpu(cuda, k_budgets):
    from repro_torch.launch.device_parity import step_parity
    step_parity("cuda", compressor="block_topk", k_budgets=k_budgets)


NEW_ARCHS = ("phi3-medium-14b", "nemotron-4-15b", "qwen1.5-110b",
             "llava-next-34b", "musicgen-large", "olmoe-1b-7b",
             "deepseek-v2-lite-16b", "zamba2-2.7b", "xlstm-1.3b")
BLOCK_TOPK_ARCHS = ("musicgen-large", "xlstm-1.3b")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_train_step_cuda_matches_cpu(cuda, arch):
    """Each new arch's smoke step on the card against the CPU: the full
    step within step_parity's tolerances, stage 2 bit for bit (musicgen
    and xlstm on their block top-K path)."""
    from repro_torch.launch.device_parity import step_parity
    step_parity("cuda", arch=arch, compressor="block_topk"
                if arch in BLOCK_TOPK_ARCHS else "sign")


@pytest.mark.parametrize("arch", ("deepseek-v2-lite-16b", "zamba2-2.7b",
                                  "xlstm-1.3b"))
def test_recurrent_and_mla_stacks_train_without_a_sync(cuda, arch):
    """The smoke loss and backward of the MLA, Mamba2 and xLSTM stacks on
    the card in bf16 under CUDA's sync debug mode "error": their Python
    loops over chunks and steps never wait for the card."""
    from repro_torch.launch.device_parity import loss_no_sync
    loss_no_sync("cuda", arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_repeats_bit_for_bit_without_a_sync(cuda, dtype):
    """The smoke olmoe's MoE layer forward and backward twice on the card:
    the same bits, no host synchronisation inside
    (`device_parity.moe_repeat`)."""
    from repro_torch.launch.device_parity import moe_repeat
    moe_repeat("cuda", dtype)


def test_moe_router_refuses_tf32(cuda):
    """With TF32 turned on the MoE layer refuses to route rather than run
    its router in TF32."""
    from repro_torch.configs import REGISTRY
    from repro_torch.nn import moe as MOE
    cfg = REGISTRY["olmoe-1b-7b"].smoke
    p = {k: torch.zeros(v, device=cuda)
         for k, v in MOE.leaf_shapes(cfg).items()}
    x = torch.zeros((1, 8, cfg.d_model), device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            MOE.apply_moe(p, x, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_init_on_the_card_equals_the_cpu(cuda):
    """theta0 = JAX's init_params(PRNGKey(seed)) on both devices (C13)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.nn.models import Model
    spec = REGISTRY["gemma2-2b"]
    for seed in (0, 7):
        a = Model(spec.smoke, chunk_ranks=4, group_size=32, device="cpu")
        b = Model(spec.smoke, chunk_ranks=4, group_size=32, device=cuda)
        a.init_(seed)
        b.init_(seed)
        assert torch.equal(a.theta, b.theta.cpu())


@pytest.mark.parametrize("compressor,k_budgets,mode", [
    ("sign", None, "cocoef"), ("block_topk", (8, 8, 4, 2), "cocoef"),
    ("sign", None, "coco"), ("identity", None, "cocoef"),
    ("sign", None, "dense"), ("topk", None, "cocoef")])
def test_metrics_leave_kernels_and_bits_alone(cuda, compressor, k_budgets,
                                              mode):
    """TrainRun(metrics=True) on the card: the same kernel launches and
    theta and e bits as metrics=False, and a frame equal to the CPU's
    within the float sums' order (the integer fields exactly)."""
    _metrics_on_card(compressor=compressor, k_budgets=k_budgets, mode=mode)


@pytest.mark.parametrize("compressor,k_budgets", [
    ("block_topk", None), ("block_topk", (8, 8, 4, 2)), ("topk", None),
    ("sign", None)])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_metrics_on_bf16_e_leave_kernels_and_bits_alone(
        cuda, compressor, k_budgets, param_dtype):
    """`test_metrics_leave_kernels_and_bits_alone` with bf16 error vectors
    (ef_dtype), theta f32 (acc kept in a buffer of the frame's own) or
    bf16 (acc kept in ghat's bucket)."""
    _metrics_on_card(compressor=compressor, k_budgets=k_budgets,
                     mode="cocoef", ef_dtype="bfloat16",
                     param_dtype=param_dtype)


def _metrics_on_card(**kw):
    import numpy as np
    from _torch_cases import _port_setup
    from repro_torch.kernels.common import launches
    from repro_torch.obs import frame_to_host
    runs = {}
    for device, metrics in (("cuda", False), ("cuda", True), ("cpu", True)):
        s = _port_setup(device=device, metrics=metrics, straggler="markov",
                        **kw)
        e = s.init_state()
        before = dict(launches)
        for t in range(2):
            res = s.train_step(s.model, e, s.make_batch(t), t)
        runs[(device, metrics)] = (
            s.model.theta.cpu(), None if e is None else e.cpu(),
            {k: v - before[k] for k, v in launches.items()},
            frame_to_host(res["telemetry"]) if metrics else None)
    off, on, cpu = runs[("cuda", False)], runs[("cuda", True)], \
        runs[("cpu", True)]
    assert torch.equal(off[0], on[0]) and off[2] == on[2]
    assert (off[1] is None) or torch.equal(off[1], on[1])
    for k, v in cpu[3].items():
        if k in ("participation", "participants", "wire_bytes_rank",
                 "bytes_up_total", "bucket_wire_bytes_rank", "bytes_down"):
            assert on[3][k] == v, k
        else:
            np.testing.assert_allclose(on[3][k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def _bits(t):
    t = t.cpu()
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.uint16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _same(a, b) -> bool:
    return torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("block_size", tp.SUPPORTED_BLOCK_SIZES)
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [0.0, 1.0])
def test_ef_topk_fused_kernel_matches_plain(cuda, block_size, k,
                                            value_dtype, mask):
    n = block_size * 8 * 37
    g, e = topk_inputs(n, block_size, k, seed=block_size + k)
    gt, et = torch.from_numpy(g).to(cuda), torch.from_numpy(e).to(cuda)
    before = tp.launches["ef_topk_fused"]
    got = tp.ef_topk_fused(gt, et, float(GAMMA), mask, k, block_size,
                           value_dtype, want_c=True)
    torch.cuda.synchronize()
    assert tp.launches["ef_topk_fused"] == before + 1
    want = ref.ef_topk_fused_ref(gt, et, float(GAMMA), mask, k, block_size,
                                 value_dtype)
    assert torch.equal(got[0].to(torch.int32), want[0])
    assert _same(got[1].float(), want[1])
    for a, b in zip(got[2:], want[2:]):
        assert _same(a, b)
    # in place (e_new aliases e) on payload rows, as the train step runs it
    e2 = et.clone()
    rows = tuple(torch.empty((2,) + t.shape, dtype=t.dtype, device=cuda)
                 for t in got[:3])
    tp.ef_topk_fused(gt, e2, float(GAMMA), mask, k, block_size, value_dtype,
                     out=tuple(r[1] for r in rows) + (e2,))
    torch.cuda.synchronize()
    for r, a in zip(rows, got[:3]):
        assert _same(r[1], a)
    assert _same(e2, got[4])


@pytest.mark.parametrize("block_size", tp.SUPPORTED_BLOCK_SIZES)
@pytest.mark.parametrize("k,k_send", [(8, 1), (8, 4), (32, 7), (32, 31)])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [0.0, 1.0])
def test_budgeted_topk_kernels_match_plain(cuda, block_size, k, k_send,
                                           value_dtype, mask):
    """ef_topk_fused and topk_pack with a rank's budget k_send < k (values
    past slot k_send +0, c and e' from the first k_send slots) against
    their plain versions, every output bit for bit, e' in place too."""
    n = block_size * 8 * 37
    g, e = topk_inputs(n, block_size, k, seed=block_size + k_send)
    gt, et = torch.from_numpy(g).to(cuda), torch.from_numpy(e).to(cuda)
    got = tp.ef_topk_fused(gt, et, float(GAMMA), mask, k, block_size,
                           value_dtype, want_c=True, k_send=k_send)
    torch.cuda.synchronize()
    want = ref.ef_topk_fused_ref(gt, et, float(GAMMA), mask, k, block_size,
                                 value_dtype, k_send)
    assert torch.equal(got[0].to(torch.int32), want[0])
    assert _same(got[1].float(), want[1])
    for a, b in zip(got[2:], want[2:]):
        assert _same(a, b)
    e2 = et.clone()
    tp.ef_topk_fused(gt, e2, float(GAMMA), mask, k, block_size, value_dtype,
                     out=tuple(torch.empty_like(t) for t in got[:3]) + (e2,),
                     k_send=k_send)
    torch.cuda.synchronize()
    assert _same(e2, got[4])
    x = gt + et
    idx, val, scales = tp.topk_pack(x, k, block_size, value_dtype,
                                    k_send=k_send)
    torch.cuda.synchronize()
    i0, v0, s0 = ref.topk_pack_ref(x, k, block_size, k_send)
    assert torch.equal(idx.to(torch.int32), i0)
    assert _same(val, v0.to(val.dtype))
    assert _same(scales, s0)


@pytest.mark.parametrize("block_size", tp.SUPPORTED_BLOCK_SIZES)
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_topk_pack_kernel_matches_plain(cuda, block_size, k, value_dtype):
    n = block_size * 8 * 29
    g, e = topk_inputs(n, block_size, k, seed=k)
    x = torch.from_numpy(g + e).to(cuda)
    before = tp.launches["topk_pack"]
    idx, val, scales = tp.topk_pack(x, k, block_size, value_dtype)
    torch.cuda.synchronize()
    assert tp.launches["topk_pack"] == before + 1
    i0, v0, s0 = ref.topk_pack_ref(x, k, block_size)
    assert torch.equal(idx.to(torch.int32), i0)
    assert _same(val, v0.to(ref.wire_dtype(value_dtype)))
    assert _same(scales, s0)


@pytest.mark.parametrize("block_size", tp.SUPPORTED_BLOCK_SIZES)
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_topk_decode_reduce_kernel_matches_plain(cuda, block_size, k,
                                                 value_dtype):
    N, nb = 5, 8 * 23
    idx, val, scales, mask = topk_payload(N, nb, k, block_size, seed=k)
    vdt = ref.wire_dtype(value_dtype)
    idx = torch.from_numpy(idx).to(cuda).to(torch.uint16)
    val = torch.from_numpy(val).to(cuda).to(vdt)
    scales, mask = torch.from_numpy(scales).to(cuda), \
        torch.from_numpy(mask).to(cuda)
    before = tp.launches["topk_decode_reduce"]
    got = tp.topk_decode_reduce(idx, val, scales, mask, block_size)
    torch.cuda.synchronize()
    assert tp.launches["topk_decode_reduce"] == before + 1
    want = ref.topk_decode_reduce_ref(idx, val, scales, mask, block_size)
    assert _same(got, want)


def _decode_payload(N, nb, k, block_size, value_dtype, offset, budgets,
                    seed):
    """Payloads for the tile-shape cases: distinct positions, values of both
    signs with a -0.0, scales with a 1.0, +0 past a sender's budget; each
    tensor on the card `offset` elements into its buffer."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((N, nb, block_size)), axis=-1)[..., :k]
    val = rng.standard_normal((N, nb, k)).astype(np.float32)
    val[0, 0, 0] = -0.0
    for i, b in enumerate(budgets or ()):
        val[i, :, b:] = 0.0
    scales = np.exp2(rng.uniform(-14, 3, (N, nb))).astype(np.float32)
    scales[:, 0] = 1.0

    def put(a, dtype):
        t = torch.from_numpy(a.reshape(-1)).to(dtype)
        buf = torch.empty(offset + t.numel(), dtype=dtype, device="cuda")
        buf[offset:].copy_(t)
        return buf[offset:].view(a.shape)
    return (put(idx.astype(np.int16), torch.int16).view(torch.uint16),
            put(val, ref.wire_dtype(value_dtype)), put(scales, torch.float32))


# (N, nb as a function of the tile's T blocks, k, mask, budgets, offset):
# the shapes the kernel's tile plan handles itself
DECODE_SHAPES = {
    "partial_last_tile": (4, lambda T: 2 * T + 5, 8, (1, 0, 1, 1), None, 0),
    "under_one_tile": (4, lambda T: T - 3, 8, (1, 1, 0, 1), None, 0),
    "one_block": (4, lambda T: 1, 8, (1, 1, 1, 0), None, 0),
    "nb_k_odd_unaligned": (4, lambda T: T + 7, 3, (1, 0, 1, 1), None, 1),
    "one_sender": (1, lambda T: T + 2, 8, (1,), None, 0),
    "nine_senders": (9, lambda T: 2 * T + 1, 5,
                     (1, 0, 1, 0.75, 1, 1, 0, 1, 1), None, 3),
    "mask_all_zero": (4, lambda T: T + 1, 32, (0, 0, 0, 0), None, 0),
    "budgets": (4, lambda T: 2 * T + 3, 8, (1, 1, 1, 0), (8, 8, 3, 1), 0),
}


@pytest.mark.parametrize("block_size", tp.SUPPORTED_BLOCK_SIZES)
@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_topk_decode_reduce_kernel_tile_shapes(cuda, block_size, shape,
                                               value_dtype):
    """A last partial tile, fewer blocks than a tile, one block, nb*k odd
    with every row off its 16-byte granule, one sender, more senders than
    ring stages, an all-zero mask and a budgeted payload: bit for bit
    against the plain version."""
    N, nb_of, k, mask, budgets, offset = DECODE_SHAPES[shape]
    nb = nb_of(tp.DECODE_TILE // block_size)
    idx, val, scales = _decode_payload(N, nb, k, block_size, value_dtype,
                                       offset, budgets, seed=nb * k)
    mask = torch.tensor(mask, dtype=torch.float32, device=cuda)
    before = tp.launches["topk_decode_reduce"]
    got = tp.topk_decode_reduce(idx, val, scales, mask, block_size)
    torch.cuda.synchronize()
    assert tp.launches["topk_decode_reduce"] == before + 1
    want = ref.topk_decode_reduce_ref(idx, val, scales, mask, block_size)
    assert _same(got, want)


def test_topk_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(128 * 8, device=cuda)
    with pytest.raises(ValueError):                 # no kernel for B=32
        tp.topk_pack(x, 8, 32)
    with pytest.raises(ValueError):                 # k > 32
        tp.topk_pack(x, 33, 256)
    with pytest.raises(ValueError):                 # no fp16 values
        tp.topk_pack(x, 8, 256, value_dtype="float16")
    with pytest.raises(ValueError):
        tp.ef_topk_fused(x, x.cpu(), 1.0, 1.0, 8, 256)


def test_kernels_on_rank_rows_match_plain(cuda):
    """The train step's layout: rank i's error is row i of an (N, n) buffer
    updated in place, its payload rows i of (N, n/32) and (N, n/g)."""
    G, N, n = 512, 4, 512 * 8 * 11
    g, e = ef_inputs(n, G, seed=3)
    gt = torch.from_numpy(g).to(cuda)
    e_all = torch.from_numpy(np.tile(e, (N, 1))).to(cuda)
    words = torch.zeros((N, n // 32), dtype=torch.uint32, device=cuda)
    scales = torch.zeros((N, n // G), device=cuda)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda)
    for i in range(N):
        sp.ef_sign_fused(gt, e_all[i], float(GAMMA), mask[i], G,
                         out=(words[i], scales[i], e_all[i]))
    got = sp.sign_decode_reduce(words, scales, mask, G)
    torch.cuda.synchronize()
    et = torch.from_numpy(e).to(cuda)
    for i in range(N):
        w, s_, _, en = ref.ef_sign_fused_ref(gt, et, float(GAMMA), mask[i], G)
        assert torch.equal(words[i], w) and torch.equal(scales[i], s_)
        assert torch.equal(e_all[i].view(torch.int32), en.view(torch.int32))
    want = ref.sign_decode_reduce_ref(words, scales, mask, G)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("group_size", sp.SUPPORTED_GROUP_SIZES)
def test_sign_pack_kernel_matches_plain(cuda, group_size):
    """Groups of +0, -0.0, denormals and all-equal first; bit for bit (the
    kernel and the plain version sum a group in one order), also written
    into rows of (N, .) payload buffers as the coco step does."""
    n = group_size * 8 * 37
    g, _ = ef_inputs(n, group_size, seed=group_size)
    x = torch.from_numpy(g).to(cuda)
    before = sp.launches["sign_pack"]
    words, scales = sp.sign_pack(x, group_size)
    torch.cuda.synchronize()
    assert sp.launches["sign_pack"] == before + 1
    w0, s0 = ref.sign_pack_ref(x, group_size)
    assert torch.equal(words, w0) and _same(scales, s0)
    rows = (torch.zeros((2, n // 32), dtype=torch.uint32, device=cuda),
            torch.zeros((2, n // group_size), device=cuda))
    sp.sign_pack(x, group_size, out=(rows[0][1], rows[1][1]))
    torch.cuda.synchronize()
    assert torch.equal(rows[0][1], w0) and _same(rows[1][1], s0)
    assert not rows[0][0].view(torch.int32).any() and not rows[1][0].any()


@pytest.mark.parametrize("block_size", tp.BLOCK_TOPK_SIZES)
@pytest.mark.parametrize("k", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_topk_kernel_matches_plain(cuda, block_size, k, dtype):
    """The adversarial rows (denormals included) and random blocks, bit
    for bit, into a new buffer and in place."""
    x = torch.from_numpy(topk_rows(block_size, seed=block_size + k,
                                   denormals=True)).to(cuda)
    x = x.to(ref.wire_dtype(dtype))
    before = tp.launches["block_topk"]
    got = tp.block_topk(x, k, block_size)
    torch.cuda.synchronize()
    assert tp.launches["block_topk"] == before + 1
    want = ref.block_topk_ref(x, k, block_size)
    assert got.dtype == x.dtype and _same(got, want)
    xi = x.clone()
    tp.block_topk(xi, k, block_size, out=xi)
    torch.cuda.synchronize()
    assert _same(xi, want)


@pytest.mark.parametrize("compressor,k_budgets", [
    ("sign", None), ("block_topk", None), ("block_topk", (8, 8, 4, 2))])
def test_coco_train_step_cuda_matches_cpu(cuda, compressor, k_budgets):
    """The coco step on the card against the CPU: stage 2 bit for bit, e
    untouched."""
    from repro_torch.launch.device_parity import step_parity
    step_parity("cuda", compressor=compressor, k_budgets=k_budgets,
                mode="coco")


def _check_flash(q, k, v, softcap, window, groups):
    """One launch on its dtype's route, within `allowed_error` of the plain
    version, and the same bits on a repeat (no atomics)."""
    route = "tensor_core" if q.dtype == torch.bfloat16 else "cuda_core"
    before = fa.launches["flash_attention"]
    routes = dict(flash_routes)
    got = fa.flash_attention(q, k, v, softcap=softcap, window=window,
                             groups=groups)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    assert flash_routes == {**routes, route: routes[route] + 1}
    want = ref.flash_attention_ref(q, k, v, softcap, window, groups)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs()
    assert bool((err <= fa.allowed_error(got, want)).all()), err.max().item()
    again = fa.flash_attention(q, k, v, softcap=softcap, window=window,
                               groups=groups)
    assert _same(again, got)                      # no atomics: deterministic


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 1000, 4096])
@pytest.mark.parametrize("window", [0, 1, 64, 5000])
@pytest.mark.parametrize("softcap,q_scale", [(0.0, 1.0), (50.0, 1.0),
                                             (50.0, 100.0)])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("hd", [16, 64, 288])
def test_flash_attention_kernel_matches_plain(cuda, hd, groups, softcap,
                                              q_scale, window, S, dtype):
    """Within `flash_attention.allowed_error` of the plain version: f32 as
    JAX's kernel test (2e-4 relative, 2e-5 absolute) on the CUDA-core
    kernel, bf16 one bf16 ulp on the tensor-core kernel; S at the edges of
    the bf16 kernel's tiles (128 query rows, 64 keys).  The largest raw
    score of most rows sits at a masked position; q_scale = 100 puts the
    scores far past the softcap."""
    q, k, v = (t.to(cuda) for t in flash_inputs(2, 2, groups, S, hd, dtype,
                                                seed=hd + S, q_scale=q_scale))
    _check_flash(q, k, v, softcap, window, groups)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 1000, 4096])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("softcap,q_scale", [(0.0, 1.0), (50.0, 100.0)])
@pytest.mark.parametrize("groups", [1, 6, 7, 8])
@pytest.mark.parametrize("hd", [64, 80, 128])
def test_flash_attention_kernel_at_the_families_head_widths(
        cuda, hd, groups, softcap, q_scale, window, S, dtype):
    """The prefill's head widths of the served archs: hd 128 (phi3,
    nemotron, qwen, llava, olmoe; the tensor-core route pads it to 192),
    hd 80 (zamba2's shared block: 2.5 TMA boxes of 32 columns, padded to
    96) and hd 64 (musicgen), at group ratios 1, 6, 7 and 8 (nemotron and
    llava have 6 and 7: not powers of 2)."""
    q, k, v = (t.to(cuda) for t in flash_inputs(2, 2, groups, S, hd, dtype,
                                                seed=hd + S + groups,
                                                q_scale=q_scale))
    _check_flash(q, k, v, softcap, window, groups)


@pytest.mark.parametrize("hd,groups", [(128, 4), (80, 1), (64, 1)])
def test_flash_attention_kernel_at_the_serve_cells(cuda, hd, groups):
    """bf16 at one serve cell's layer shape each, S 4096 (phi3's
    H 40 / Hkv 10 at hd 128; zamba2's 32 / 32 at hd 80; musicgen's 32 /
    32 at hd 64), B 1, 8 kv heads."""
    q, k, v = (t.to(cuda) for t in flash_inputs(1, 8, groups, 4096, hd,
                                                "bfloat16", seed=hd))
    _check_flash(q, k, v, 0.0, 0, groups)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 4096])
def test_flash_attention_kernel_at_serve_length(cuda, window, dtype):
    """gemma2-2b's layer at the serve slice's S = 8192 (B 1, groups 2, hd
    288, softcap 50): global and with the local layers' window of 4096."""
    q, k, v = (t.to(cuda) for t in flash_inputs(1, 2, 2, 8192, 288, dtype,
                                                seed=8192))
    _check_flash(q, k, v, 50.0, window, 2)


def test_flash_attention_raises_instead_of_falling_back(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):                  # hd over the tiles
        z = torch.zeros((1, 2, 8, 320), device=cuda)
        fa.flash_attention(z, z, z)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :1], q[:, :1], groups=3)
    with pytest.raises(RuntimeError):
        fa.flash_attention(q.requires_grad_(), q, q)
    with pytest.raises(ValueError):                  # bf16: TMA rows
        z = torch.zeros((1, 2, 8, 12), device=cuda, dtype=torch.bfloat16)
        fa.flash_attention(z, z, z)
    with pytest.raises(ValueError):                  # bf16: 16-byte aligned
        z = torch.zeros(1 + 2 * 8 * 16, device=cuda, dtype=torch.bfloat16)
        z = z[1:].view(1, 2, 8, 16)
        fa.flash_attention(z, z, z)


def test_serve_cuda_matches_cpu(cuda):
    """Prefill and 4 decode steps of the smoke config on the card against
    the CPU (`launch/device_parity.serve_parity`), f32 and bf16."""
    from repro_torch.launch.device_parity import serve_parity
    serve_parity("cuda")


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "nemotron-4-15b",
                                  "qwen1.5-110b", "llava-next-34b",
                                  "musicgen-large", "olmoe-1b-7b",
                                  "deepseek-v2-lite-16b", "zamba2-2.7b",
                                  "xlstm-1.3b"])
def test_serve_families_cuda_match_cpu(cuda, arch):
    """`serve_parity` of every other arch's smoke config: prefill, every
    cache leaf and 4 decode steps, card against CPU."""
    from repro_torch.launch.device_parity import serve_parity
    serve_parity("cuda", arch=arch)


# --- global top-K and the dense wire ---------------------------------------

@pytest.mark.parametrize("nd,B", [(4, 4_096), (4, 41_120), (3, 70_000),
                                  (2, 256 * 1_000)])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [1.0, 0.0])
def test_global_topk_route_matches_plain(cuda, nd, B, value_dtype, mask):
    """The global route on the card (rounds of the topk_pack kernel) against
    the plain stable sort of whole chunks on the CPU, bit for bit: payload,
    c, e' (in place) and acc left in g; topk_pack and the union decode
    too.  B > 65,536 gets u32 indices; the adversarial chunks of
    `topk_chunks` (a far-apart tie at the k-th, fewer than k nonzeros with
    -0.0 and a denormal, all zero) come first."""
    from _torch_cases import KB, topk_chunks
    g = topk_chunks(nd, B, seed=B)
    e = (np.random.default_rng(nd).standard_normal(nd * B) * 1e-3).astype(
        np.float32)
    e[B:3 * B] = -0.0
    e[[1, B - 2]] = 0.0
    e[300:300 + KB - 1] = 0.0
    gt, et = torch.from_numpy(g).to(cuda), torch.from_numpy(e).to(cuda)
    before = dict(tp.launches)
    got = tp.ef_topk_fused(gt, et, 1.0, mask, KB, B, value_dtype,
                           want_c=True,
                           out=tp._payload_out(None, nd, KB, B,
                                               ref.wire_dtype(value_dtype),
                                               gt.device) + (et,))
    torch.cuda.synchronize()
    assert tp.launches["topk_pack"] - before["topk_pack"] == \
        tp.global_rounds(B, KB)                   # the rounds, one launch
    assert tp.launches["ef_topk_fused"] == before["ef_topk_fused"]
    want = ref.ef_topk_fused_ref(torch.from_numpy(g), torch.from_numpy(e),
                                 1.0, mask, KB, B, value_dtype)
    assert got[0].dtype == tp.index_dtype(B)
    assert torch.equal(got[0].cpu().to(torch.int64), want[0].to(torch.int64))
    assert _same(got[1].float(), want[1])
    for a, b in zip(got[2:], want[2:]):
        assert _same(a, b)
    assert _same(gt, ref.mul_add(1.0, torch.from_numpy(g),
                                 torch.from_numpy(e)))
    x = torch.from_numpy(g).to(cuda)
    packed = tp.topk_pack(x, KB, B, value_dtype)
    wp = ref.topk_pack_ref(torch.from_numpy(g), KB, B)
    assert torch.equal(packed[0].cpu().to(torch.int64), wp[0].to(torch.int64))
    assert _same(packed[1].float(), wp[1].to(packed[1].dtype).float())
    assert _same(packed[2], wp[2])
    senders = [got[:3], packed, got[:3]]
    idx = torch.stack([p[0].to(torch.int64) for p in senders])
    val = torch.stack([p[1] for p in senders])
    sc = torch.stack([p[2] for p in senders])
    m = torch.tensor([1.0, 0.0, 1.0], device=cuda)
    dec = tp.topk_decode_reduce(idx.to(tp.index_dtype(B)), val, sc, m, B)
    assert _same(dec, ref.topk_decode_reduce_ref(idx.cpu(), val.cpu(),
                                                 sc.cpu(), m.cpu(), B))


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [1.0, 0.0])
def test_dense_wire_on_card_matches_cpu(cuda, value_dtype, mask,
                                        monkeypatch):
    """The dense wire's local step (`local_chunks`, CHUNK made small),
    roundtrip, fold and stacked decode on the card against the CPU, bit
    for bit."""
    from repro_torch.core import collectives
    monkeypatch.setattr(collectives, "CHUNK", 1000)
    w = collectives.DenseWire(value_dtype)
    g, e = ef_inputs(32 * 8 * 37, 32, seed=7)
    out = []
    for dev in ("cpu", cuda):
        gt = torch.from_numpy(g.copy()).to(dev)
        et = torch.from_numpy(e.copy()).to(dev)
        ghat = torch.zeros_like(gt)
        c = torch.full_like(gt, float("nan"))
        for sl, cc in w.local_chunks(gt, et,
                                     torch.tensor(GAMMA, device=dev),
                                     torch.tensor(mask, device=dev)):
            c[sl] = cc
        out.append(c.clone())
        w.fold_(ghat, c, torch.tensor(0.5, device=dev))
        x = w.roundtrip_(torch.from_numpy(g * np.float32(3.3)).to(dev))
        w.fold_(ghat, x, torch.tensor(1.0, device=dev))
        stacked = torch.stack([et, ghat, et]).to(w.vdt)
        dec = w.decode_reduce((stacked,), torch.tensor([1.0, 0.0, 1.0],
                                                       device=dev))
        out.append((gt, et, ghat, x, dec))
    for a, b in zip(out[1], out[3]):
        assert _same(a, b)
    assert _same(out[0], out[2])


@pytest.mark.parametrize("name", ["identity", "identity_bf16",
                                  "identity_coco", "topk", "topk_coco",
                                  "dense"])
def test_new_paths_train_step_cuda_matches_cpu(cuda, name):
    from repro_torch.launch.device_parity import step_parity
    kw = {"identity": {"compressor": "identity"},
          "identity_bf16": {"compressor": "identity",
                            "wire_dtype": "bfloat16"},
          "identity_coco": {"compressor": "identity", "mode": "coco"},
          "topk": {"compressor": "topk"},
          "topk_coco": {"compressor": "topk", "mode": "coco"},
          "dense": {"mode": "dense"}}[name]
    step_parity("cuda", **kw)


BUCKET_KNOBS = {
    "sign_b2_pipelined": {"num_buckets": 2},
    "sign_b2_serial": {"num_buckets": 2, "bucket_schedule": "serial"},
    "block_topk_b2": {"compressor": "block_topk", "num_buckets": 2},
    "block_topk_b2_serial": {"compressor": "block_topk", "num_buckets": 2,
                             "bucket_schedule": "serial"},
    "sign_phase2_bf16": {"phase2_dtype": "bfloat16"},
    "sign_phase2_sign": {"phase2_sign": True},
    "block_topk_phase2_sign": {"compressor": "block_topk",
                               "phase2_sign": True, "num_buckets": 2},
    "coco_sign_b2": {"mode": "coco", "num_buckets": 2},
}


@pytest.mark.parametrize("name", list(BUCKET_KNOBS))
def test_bucketed_and_phase2_step_cuda_matches_cpu(cuda, name):
    """The bucketed and phase-2 step on the card against the CPU: stage 2
    bit for bit (`device_parity.step_parity`)."""
    from repro_torch.launch.device_parity import step_parity
    step_parity("cuda", **BUCKET_KNOBS[name])


@pytest.mark.parametrize("compressor", ["sign", "block_topk", "identity"])
@pytest.mark.parametrize("buckets,schedule", [(1, "pipelined"),
                                              (2, "serial"),
                                              (2, "pipelined")])
def test_parity_gate_on_card(cuda, compressor, buckets, schedule):
    """The reference loop against the one-device step on the card, at
    JAX's parity sizes, bit for bit, and the loop's theta on the card equal
    to the CPU's."""
    from repro_torch.launch.parity import (assert_parity, reference_loop,
                                           run_parity)
    assert_parity(run_parity(compressor, num_buckets=buckets,
                             bucket_schedule=schedule, device="cuda"))
    a, b = (reference_loop(compressor, device=d) for d in ("cuda", "cpu"))
    for x, y in zip(a, b):
        assert torch.equal(x.cpu().view(torch.int32), y.view(torch.int32))


# --- the bf16 instances (TrainRun.param_dtype / ef_dtype) -----------------

DTYPE_PAIRS = [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
               ("float32", "bfloat16")]


def _stored(x, dtype, dev):
    return torch.from_numpy(x).to(getattr(torch, dtype)).to(dev)


@pytest.mark.parametrize("group_size", [32, 512])
@pytest.mark.parametrize("gdt,edt", DTYPE_PAIRS)
@pytest.mark.parametrize("mask", [0.0, 1.0])
def test_ef_sign_fused_dtype_instances_match_plain(cuda, group_size, gdt,
                                                   edt, mask):
    """bf16 g and/or e: words, scales, c and e' (in e's dtype, the f32
    value rounded once) bit for bit, also in place."""
    n = group_size * 8 * 37
    g, e = ef_inputs(n, group_size, seed=group_size + 1)
    gt, et = _stored(g, gdt, cuda), _stored(e, edt, cuda)
    before = sp.launches["ef_sign_fused"]
    got = sp.ef_sign_fused(gt, et, float(GAMMA), mask, group_size,
                           want_c=True)
    torch.cuda.synchronize()
    assert sp.launches["ef_sign_fused"] == before + 1
    assert got[3].dtype == et.dtype
    want = ref.ef_sign_fused_ref(gt.cpu(), et.cpu(), float(GAMMA), mask,
                                 group_size)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b), (gdt, edt)
    e2 = et.clone()
    sp.ef_sign_fused(gt, e2, float(GAMMA), mask, group_size,
                     out=(torch.empty_like(got[0]),
                          torch.empty_like(got[1]), e2))
    torch.cuda.synchronize()
    assert torch.equal(e2.cpu(), want[3])


@pytest.mark.parametrize("block_size", tp.SUPPORTED_BLOCK_SIZES)
@pytest.mark.parametrize("gdt,edt", DTYPE_PAIRS)
@pytest.mark.parametrize("k,k_send", [(8, None), (8, 3), (32, 1)])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [0.0, 1.0])
def test_ef_topk_fused_dtype_instances_match_plain(cuda, block_size, gdt,
                                                   edt, k, k_send,
                                                   value_dtype, mask):
    n = block_size * 8 * 13
    g, e = topk_inputs(n, block_size, k, seed=block_size + k)
    gt, et = _stored(g, gdt, cuda), _stored(e, edt, cuda)
    got = tp.ef_topk_fused(gt, et, float(GAMMA), mask, k, block_size,
                           value_dtype, want_c=True, k_send=k_send)
    torch.cuda.synchronize()
    want = ref.ef_topk_fused_ref(gt.cpu(), et.cpu(), float(GAMMA), mask, k,
                                 block_size, value_dtype, k_send)
    assert torch.equal(got[0].cpu().to(torch.int64), want[0].to(torch.int64))
    assert torch.equal(got[1].cpu().float(), want[1])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a.cpu(), b), (gdt, edt)
    e2 = et.clone()
    tp.ef_topk_fused(gt, e2, float(GAMMA), mask, k, block_size, value_dtype,
                     out=tuple(torch.empty_like(x) for x in got[:3]) + (e2,),
                     k_send=k_send)
    torch.cuda.synchronize()
    assert torch.equal(e2.cpu(), want[4])


@pytest.mark.parametrize("group_size", sp.SUPPORTED_GROUP_SIZES)
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_sign_pack_gamma_matches_plain(cuda, group_size, xdt):
    n = group_size * 8 * 21
    g, _ = ef_inputs(n, group_size, seed=3)
    xt = _stored(g, xdt, cuda)
    gamma = torch.tensor(float(GAMMA), device=cuda)
    got = sp.sign_pack(xt, group_size, gamma=gamma)
    torch.cuda.synchronize()
    want = ref.sign_pack_ref(xt.cpu(), group_size, float(GAMMA))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("block_size", tp.SUPPORTED_BLOCK_SIZES)
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,k_send", [(8, None), (8, 3)])
def test_topk_pack_gamma_matches_plain(cuda, block_size, xdt, k, k_send):
    n = block_size * 8 * 13
    g, _ = topk_inputs(n, block_size, k, seed=5)
    xt = _stored(g, xdt, cuda)
    got = tp.topk_pack(xt, k, block_size, "bfloat16", k_send=k_send,
                       gamma=torch.tensor(float(GAMMA), device=cuda))
    torch.cuda.synchronize()
    want = ref.topk_pack_ref(xt.cpu(), k, block_size, k_send, float(GAMMA))
    assert torch.equal(got[0].cpu().to(torch.int64), want[0].to(torch.int64))
    assert torch.equal(got[1].cpu(), want[1].to(torch.bfloat16))
    assert torch.equal(got[2].cpu(), want[2])


def test_dtype_wrappers_raise_without_an_instance(cuda):
    h = torch.zeros(32 * 8, dtype=torch.float16, device=cuda)
    f = torch.zeros(32 * 8, device=cuda)
    with pytest.raises(TypeError):
        sp.ef_sign_fused(h, f, 1.0, 1.0, 32)
    with pytest.raises(TypeError):
        tp.ef_topk_fused(f, h, 1.0, 1.0, 4, 64)
    with pytest.raises(TypeError):
        sp.sign_pack(h, 32)
    with pytest.raises(TypeError):             # e' in e's dtype
        sp.ef_sign_fused(f, f.bfloat16(), 1.0, 1.0, 32,
                         out=(torch.empty(8, dtype=torch.uint32,
                                          device=cuda),
                              torch.empty(8, device=cuda), f.clone()))


@pytest.mark.parametrize("compressor,mode,k_budgets", [
    ("sign", "cocoef", None), ("block_topk", "cocoef", (8, 8, 4, 2)),
    ("sign", "coco", None), ("block_topk", "coco", None),
    ("identity", "cocoef", None), ("topk", "cocoef", None),
    ("sign", "dense", None)])
@pytest.mark.parametrize("param_dtype,ef_dtype", DTYPE_PAIRS)
def test_bf16_train_step_cuda_matches_cpu(cuda, compressor, mode, k_budgets,
                                          param_dtype, ef_dtype):
    from repro_torch.launch.device_parity import step_parity
    step_parity("cuda", compressor=compressor, mode=mode,
                k_budgets=k_budgets, param_dtype=param_dtype,
                ef_dtype=ef_dtype)


# ---- Task B, the quickstart and the elastic restart ------------------------

def test_task_b_grads_card_match_cpu_with_tf32_on(cuda):
    """Task B's per-subset gradients on the card with TF32 switched on
    globally: the same bits as with it off (`tasks.ieee_f32`), and within
    1e-5 of the CPU's largest magnitude (cuDNN and oneDNN sum the
    convolutions in other orders, as XLA:CPU against oneDNN does in
    tests/test_torch_tasks.py)."""
    from repro_torch.data import tasks
    gf, _, th0, _ = tasks.classification_task(0, device=cuda)
    cgf, _, cth0, _ = tasks.classification_task(0, device="cpu")
    off = gf(th0)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        on = gf(th0)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))
    want = cgf(cth0)
    assert float((on.cpu() - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


def test_quickstart_card_equals_cpu(cuda):
    from repro_torch.launch import quickstart
    assert quickstart.main("cuda", 31, every=10) == \
        quickstart.main("cpu", 31, every=10)


def test_elastic_restart_resume_card_equals_cpu(cuda, tmp_path):
    """The CPU's phase-1 checkpoint (smoke size) restored into a 2-rank
    setup on the card and on the CPU: theta and the rescaled e bit-equal;
    then stage 2 (`coded_update`) fed the same seeded gradients: theta, e
    and ghat bit-equal, as `device_parity` holds stage 2.  And the whole
    smoke run on the card: the CPU's masks, rates and replan epochs."""
    from repro_torch.launch import elastic_restart as er
    cpu_run = er.run(device="cpu", steps_1=2, steps_2=2,
                     ckpt=str(tmp_path), keep_ckpt=True)
    card_run = er.run(device="cuda", steps_1=2, steps_2=2)
    for key in ("mask", "rates", "epoch", "reallocated"):
        assert [r[key] for p in ("phase1", "phase2")
                for r in cpu_run[p]["steps"]] == \
            [r[key] for p in ("phase1", "phase2")
             for r in card_run[p]["steps"]]
    assert all(np.isfinite(r["loss"]) for r in card_run["phase2"]["steps"])
    flat_1 = cpu_run["phase1"]["flat_pad"]
    done = {}
    for dev in ("cpu", "cuda"):
        setup = er.build(2, device=dev)
        _, e, info = er.resume(setup, tmp_path, 2, flat_1)
        assert info["e_rows_equal"] and info["e_tail_zero"]
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, setup.flat_pad)).astype(np.float32) * 1e-2).to(dev)

        def grad_of(i, setup=setup, g=g):
            setup.model.grad.copy_(g[i])
            return setup.model.grad
        before = (setup.model.theta.cpu().clone(), e.cpu().clone())
        mask = torch.tensor([1.0, 0.0], device=dev)
        ghat = setup.coded_update(setup.model, grad_of, e, mask, 2)
        done[dev] = before + (setup.model.theta.cpu(), e.cpu(), ghat.cpu())
    for a, b in zip(done["cpu"], done["cuda"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
