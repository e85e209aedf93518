"""The arithmetic of the bf16 tensor-core flash kernel
(`csrc/flash_attention_sm90.cu`), emulated in torch on the CPU, against
the port's plain version and JAX's jnp reference.

The kernel cannot run here, so `emulate` repeats its numerics step by
step: scores in f32 from bf16 q and k (products of bf16 are exact in f32,
as on the tensor cores), the softcap as the kernel computes it (s * (1 /
cap), tanh as 1 - 2 / (e^{2y} + 1)) and the -1e30 mask, an online softmax
over the kernel's key tiles of 64 for each warpgroup's 64 query rows
(every tile of its CTA's range, fully masked ones too; p and the rescale
as exp2((s - m) * log2 e)), p in f32 split
into p_hi = bf16(p) and p_lo = bf16(p - p_hi), O += p_hi.v + p_lo.v in
f32, l the sum of the f32 p, and one rounding at the end.  It
lives in this test only; nothing on the main path uses it.

Tolerance: `flash_attention.allowed_error` unchanged (one bf16 ulp of the
larger magnitude + 2e-5), over the bf16 cases of `chip_smoke.py`'s sweep
at CPU sizes.  The negative case pins why p is split: p rounded once to
bf16 for p.v (as compiled flex_attention and FlashAttention 2/3 do) lands
beyond that tolerance on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import flash_inputs
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa, ref

BQ, WG_ROWS, BK = 128, 64, 64   # the kernel's CTA rows, consumer rows, keys
LOG2E = torch.tensor(1.4426950408889634)   # f32, as the kernel's kLog2e


def _tanh(y: torch.Tensor) -> torch.Tensor:
    """The kernel's tanh in f32: 1 - 2 / (e^{2|y|} + 1), with y's sign."""
    e = torch.exp2(y.abs() * 2.885390081777927)
    return torch.copysign(1.0 - 2.0 / (e + 1.0), y)


def emulate(q, k, v, softcap: float, window: int, groups: int,
            split: bool = True) -> torch.Tensor:
    """The kernel's numerics in torch; split=False rounds p once to bf16
    for p.v instead of splitting it.  Each row sees the key tiles of its
    CTA's range in ascending order, as in the kernel; the rows that see a
    tile form one run, so each tile updates one slice of rows."""
    B, H, S, hd = q.shape
    w = window if window > 0 else ref.BIG_WINDOW
    qf = q.float()
    kf = k.float().repeat_interleave(groups, 1)
    vf = v.float().repeat_interleave(groups, 1)
    pos = torch.arange(S)
    q0 = pos - pos % BQ                             # each row's CTA
    t_lo = (q0 - w + 1).clamp(min=0) // BK
    t_hi = ((q0 + BQ).clamp(max=S) + BK - 1) // BK
    m = torch.full((B, H, S, 1), ref.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for ti in range(int(t_hi.max())):
        seen = torch.nonzero((t_lo <= ti) & (ti < t_hi)).flatten()
        if seen.numel() == 0:
            continue
        rows = slice(int(seen[0]), int(seen[-1]) + 1)
        keys = slice(ti * BK, min(ti * BK + BK, S))
        s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
        if softcap > 0:
            s = softcap * _tanh(s * torch.tensor(1.0 / softcap))
        qpos, kpos = pos[rows][:, None], pos[keys][None, :]
        s = torch.where((kpos <= qpos) & (kpos > qpos - w), s, ref.NEG_INF)
        m_new = torch.maximum(m[:, :, rows], s.amax(-1, keepdim=True))
        alpha = torch.exp2((m[:, :, rows] - m_new) * LOG2E)
        p = torch.exp2((s - m_new) * LOG2E)
        hi = p.bfloat16().float()
        a = acc[:, :, rows] * alpha + hi @ vf[:, :, keys]
        if split:
            a = a + (p - hi).bfloat16().float() @ vf[:, :, keys]
        acc[:, :, rows] = a
        l[:, :, rows] = l[:, :, rows] * alpha + p.sum(-1, keepdim=True)
        m[:, :, rows] = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs many small products: one intra-op thread keeps
    it from competing with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _beyond(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    err = (got.float() - want.float()).abs()
    return err > fa.allowed_error(got, want)


@pytest.mark.parametrize("S", [1, 65, 1000])
@pytest.mark.parametrize("window", [0, 1, 64, "S"])
@pytest.mark.parametrize("softcap,q_scale", [(0.0, 1.0), (50.0, 1.0),
                                             (50.0, 100.0)])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("hd", [16, 64, 288])
def test_split_p_emulation_within_tolerance(hd, groups, softcap, q_scale,
                                            window, S):
    """The kernel's arithmetic holds the plain version within the
    unchanged bf16 tolerance on every entry."""
    w = S if window == "S" else window
    q, k, v = flash_inputs(2, 2, groups, S, hd, "bfloat16", seed=hd + S,
                           q_scale=q_scale)
    got = emulate(q, k, v, softcap, w, groups)
    want = ref.flash_attention_ref(q, k, v, softcap, w, groups)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert not bool(_beyond(got, want).any()), \
        (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("hd,softcap,window", [
    (288, 50.0, 0), (288, 50.0, 64), (64, 0.0, 0), (16, 50.0, 1000)])
def test_split_p_emulation_matches_jax_ref(hd, softcap, window):
    """The same against JAX's jnp reference (`repro.kernels.ref`)."""
    q, k, v = flash_inputs(1, 2, 2, 1000, hd, "bfloat16", seed=hd)
    got = emulate(q, k, v, softcap, window, 2)
    args = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
            for t in (q, k, v)]
    want = jref.flash_attention_ref(*args, softcap=softcap, window=window,
                                    groups=2)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    assert not bool(_beyond(got, want).any())


@pytest.mark.parametrize("hd,softcap,q_scale,window", [
    (288, 50.0, 1.0, 0), (288, 0.0, 1.0, 64), (64, 50.0, 100.0, 0),
    (16, 0.0, 1.0, 1000)])
def test_p_rounded_once_misses_tolerance(hd, softcap, q_scale, window):
    """Without the split (p rounded once to bf16) the same arithmetic
    lands beyond the tolerance, while the split holds it: why the kernel
    pays for a second p.v product."""
    q, k, v = flash_inputs(2, 2, 2, 1000, hd, "bfloat16", seed=hd + 1000,
                           q_scale=q_scale)
    want = ref.flash_attention_ref(q, k, v, softcap, window, 2)
    once = _beyond(emulate(q, k, v, softcap, window, 2, split=False), want)
    assert bool(once.any())
    assert not bool(_beyond(emulate(q, k, v, softcap, window, 2),
                            want).any())


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """An edited header of `csrc/` names another library, so a stale one
    is never loaded; the tensor-core source is among those built."""
    from repro_torch.kernels import build
    assert "flash_attention_sm90" in build.SOURCES
    assert (build.CSRC / "flash_attention_sm90.cu").is_file()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "common.cuh").write_text("// header\n")
    first = build._target("k")
    assert build._target("k") == first
    (tmp_path / "common.cuh").write_text("// header, edited\n")
    second = build._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert build._target("k") not in (first, second)


def test_cpu_tensors_take_the_plain_version_on_no_route():
    """The card's bf16 rules (hd % 8 == 0, 16-byte alignment) do not apply
    to CPU tensors, which run the plain version and count no launch."""
    from repro_torch.kernels.common import flash_routes, launches
    q, k, v = flash_inputs(1, 2, 2, 40, 12, "bfloat16", seed=12)
    before = (dict(flash_routes), launches["flash_attention"])
    got = fa.flash_attention(q, k, v, softcap=50.0, window=0, groups=2)
    assert (dict(flash_routes), launches["flash_attention"]) == before
    assert torch.equal(got.view(torch.int16), ref.flash_attention_ref(
        q, k, v, 50.0, 0, 2).view(torch.int16))
