"""A CPU twin of the block top-K selection of `csrc/topk_pack.cu`
(`warp_select`, shared by ef_topk_fused, topk_pack and block_topk).

The twin follows the kernel step for step, in numpy over many blocks at
once: the 32 lanes of a warp and their P = B/32 elements, each lane's
64-bit candidate keys, the compare-exchanges of `sort_desc<P>` read from
the CUDA source itself, the per-lane lists with their sentinel, the k
rounds of two max reductions (over the heads' high words, then over the
low words of the lanes that hold that maximum), and the kept test of the
kernels' epilogues (a key at least that of slot k_send - 1).  It is held bit for bit to the plain version
(`ref.topk_select`, the kernel's contract) and to JAX's `lax.top_k` order
on adversarial blocks: ties across lanes and within a lane, +-0.0,
all-zero blocks, +-inf and denormals (C6: XLA:CPU flushes denormals, so
the JAX comparison leaves the denormal blocks to the plain version).  So a
logic fault of the selection shows here before any card runs it.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc" / "topk_pack.cu"
U32 = np.uint64(0xFFFFFFFF)


def sort_network(P: int):
    """The compare-exchange pairs of the kernel's `sort_desc<P>`, in
    order, read from the CUDA source."""
    src = CU.read_text()
    m = re.search(r"sort_desc<%d>\(u64 \(&v\)\[%d\]\) \{(.*?)\n\}" % (P, P),
                  src, re.S)
    assert m, f"no sort_desc<{P}> in {CU.name}"
    return [(int(a), int(b))
            for a, b in re.findall(r"CE\((\d+), (\d+)\)", m.group(1))]


def twin_select(x: np.ndarray, k: int, k_send: int):
    """The kernel's selection (`warp_select`) on blocks x (nb, B) f32.
    Returns (pos (nb, k) in-block positions of the slots, val (nb, k) f32
    their signed values, max_bits (nb,), kept (nb, B) bool: the elements of
    the first k_send slots, as the kernels test them: key >= the key of
    slot k_send - 1)."""
    nb, B = x.shape
    P = B // 32
    bits = x.view(np.uint32).reshape(nb, P, 32).transpose(0, 2, 1)
    bits = bits.astype(np.uint64)                    # (nb, lane, w)
    pos = (32 * np.arange(P)[None, None, :] + np.arange(32)[None, :, None])
    pos = pos.astype(np.uint64)

    def cand_key(b, p):
        lo = np.uint64(0x80000000) | ((np.uint64(511) - p) << np.uint64(1)) \
            | (b >> np.uint64(31))
        return ((b & np.uint64(0x7FFFFFFF)) << np.uint64(32)) | lo

    keys = cand_key(bits, pos)
    v = keys.copy()
    for a, b in sort_network(P):                     # sort_desc<P>
        xa, yb = v[..., a].copy(), v[..., b].copy()
        s = yb > xa
        v[..., a] = np.where(s, yb, xa)
        v[..., b] = np.where(s, xa, yb)
    lists = np.concatenate(                          # the sentinel: key 0
        [v, np.zeros((nb, 32, 1), np.uint64)], axis=2)
    h = np.zeros((nb, 32), np.int64)
    rows, lanes = np.arange(nb)[:, None], np.arange(32)[None, :]
    slots = np.zeros((nb, k), np.uint64)
    for r in range(k):
        key = lists[rows, lanes, h]                  # every lane's head
        hi = (key >> np.uint64(32)).astype(np.int64)
        m_hi = hi.max(axis=1, keepdims=True)         # __reduce_max_sync
        c = np.where(hi == m_hi, key & U32, 0)
        m_lo = c.max(axis=1, keepdims=True)          # __reduce_max_sync
        win = c == m_lo
        assert (win.sum(axis=1) == 1).all()          # one winner a round
        h = h + win
        assert (h <= P).all()                        # within the lists
        slots[:, r] = (m_hi[:, 0].astype(np.uint64) << np.uint64(32)) \
            | m_lo[:, 0].astype(np.uint64)
    shi, slo = slots >> np.uint64(32), slots & U32
    out_pos = 511 - ((slo >> np.uint64(1)) & np.uint64(511)).astype(np.int64)
    val = (shi | ((slo & np.uint64(1)) << np.uint64(31))).astype(np.uint32) \
        .view(np.float32)
    kept = keys >= slots[:, k_send - 1][:, None, None]
    kept_flat = kept.transpose(0, 2, 1).reshape(nb, B)
    return out_pos, val, shi[:, 0].astype(np.int64), kept_flat


def adversarial_blocks(B: int, k: int, seed: int) -> np.ndarray:
    """(nb, B) f32: random blocks, then blocks of every kind the selection
    must get right."""
    rng = np.random.default_rng(seed)
    P = B // 32
    blocks = [rng.standard_normal((24, B)).astype(np.float32)
              * np.exp(rng.uniform(-20, 20, (24, 1))).astype(np.float32)]

    def add(b):
        blocks.append(np.asarray(b, np.float32).reshape(1, B))

    add(np.zeros(B))                                     # all +0
    add(np.full(B, -0.0))                                # all -0.0
    add(np.where(rng.random(B) < 0.5, 0.0, -0.0))        # mixed signed zeros
    add(np.where(rng.random(B) < 0.5, 1.0, -1.0))        # every |x| equal
    b = rng.standard_normal(B) * 1e-3                    # ties across lanes
    b[1:1 + 3 * (k + 1):3] = 3.0
    b[2:2 + 6 * (k // 2 + 1):6] = -3.0
    b[1 + 3 * (k + 1) % B] = 5.0
    add(b)
    b = rng.standard_normal(B) * 1e-3                    # ties within a lane
    b[7::32] = -2.0
    b[9::32] = 2.0
    add(b)
    b = np.zeros(B)                                      # one lane holds the
    b[3::32] = np.arange(P, 0, -1) + 10.0                # P largest: its list
    add(b)                                               # runs out (k > P)
    b = np.zeros(B)                                      # exactly k nonzeros
    b[rng.choice(B, k, replace=False)] = rng.standard_normal(k)
    add(b)
    b = np.zeros(B)                                      # fewer than k
    b[rng.choice(B, max(1, k // 2), replace=False)] = -1.5
    add(b)
    b = rng.standard_normal(B)                           # +-inf
    b[rng.choice(B, 3, replace=False)] = np.inf
    b[rng.choice(B, 2, replace=False)] = -np.inf
    add(b)
    tiny = np.float32(1e-40)                             # denormals (C6)
    add(rng.integers(-3, 4, B).astype(np.float32) * tiny)
    add(np.where(rng.random(B) < 0.7, 0.0,
                 rng.integers(1, 50, B) * tiny * np.sign(rng.random(B) - .5)))
    blocks.append(rng.integers(-3, 4, (32, B)).astype(np.float32))  # few
    #                                                        distinct values
    return np.concatenate(blocks)


def _has_denormal(x: np.ndarray) -> np.ndarray:
    return ((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)).any(axis=1)


@pytest.mark.parametrize("B", [64, 128, 256, 512])
@pytest.mark.parametrize("k", [1, 2, 7, 8, 16, 31, 32])
def test_twin_selection_is_lax_top_k(B, k):
    x = adversarial_blocks(B, k, seed=B + k)
    k_send = max(1, k // 2)
    pos, val, max_bits, kept = twin_select(x, k, k_send)
    # the plain version: indices, values bit for bit, the block max
    idx, sv = ref.topk_select(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pos, idx.numpy())
    np.testing.assert_array_equal(val.view(np.int32),
                                  sv.numpy().view(np.int32))
    np.testing.assert_array_equal(
        max_bits, np.abs(x).view(np.int32).max(axis=1))
    want_kept = np.zeros_like(kept)
    np.put_along_axis(want_kept, idx.numpy()[:, :k_send], True, axis=1)
    np.testing.assert_array_equal(kept, want_kept)
    # JAX's lax.top_k order on |x|, where XLA keeps the values (no
    # denormals)
    normal = ~_has_denormal(x)
    _, jidx = jax.lax.top_k(np.abs(x[normal]), k)
    np.testing.assert_array_equal(pos[normal], np.asarray(jidx))


@pytest.mark.parametrize("P", [2, 4, 8, 16])
def test_sort_networks_sort(P):
    """Every 0/1 input comes out sorted (the 0-1 principle: so does every
    input), with the kernel's compare-exchanges."""
    v = ((np.arange(1 << P)[:, None] >> np.arange(P)) & 1).astype(np.int64)
    for a, b in sort_network(P):
        hi, lo = np.maximum(v[:, a], v[:, b]), np.minimum(v[:, a], v[:, b])
        v[:, a], v[:, b] = hi, lo
    assert (np.diff(v, axis=1) <= 0).all()
