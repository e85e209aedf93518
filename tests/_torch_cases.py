"""Inputs and comparisons shared by the port's kernel tests (numpy only,
so the GPU tests, which run without JAX, can use them too)."""
import numpy as np


def ef_inputs(n: int, group_size: int, seed: int, denormals: bool = True):
    """(g, e) f32 of length n with adversarial groups first: all zeros,
    -0.0 everywhere, denormals (or, with denormals=False, the smallest
    normal numbers), exact cancellation to +0 (g = 1, e = -gamma for
    GAMMA), then random groups of widely varying scale."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n).astype(np.float32)
    mag = np.exp(rng.uniform(-20, 5, n // group_size)).astype(np.float32)
    g *= np.repeat(mag, group_size)
    e *= np.repeat(mag, group_size) * np.float32(0.01)
    G = group_size
    g[:G] = 0.0
    e[:G] = 0.0
    g[G:2 * G] = -0.0
    e[G:2 * G] = -0.0
    sgn = np.where(rng.random(G) < 0.5, -1.0, 1.0).astype(np.float32)
    tiny = np.float32(1.0) if denormals else np.float32(1e6)
    g[2 * G:3 * G] = sgn * np.float32(1e-40) * tiny
    e[2 * G:3 * G] = -sgn * np.float32(3e-41) * tiny
    g[3 * G:4 * G] = 1.0
    e[3 * G:4 * G] = -GAMMA
    return g, e


GAMMA = np.float32(0.37)


def ulp_diff(a, b) -> np.ndarray:
    """Distance in units in the last place between f32 arrays of one sign
    (both >= 0: group scales)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def check_ef_outputs(ref, got, group_size: int, max_ulp: int = 2,
                     fma_ref: bool = False):
    """ref/got = (words, scales, c, e_new) numpy.  Words exact, scales
    within max_ulp.  c and e_new are exact where the group scales agree;
    elsewhere c is within max_ulp ulps of the scale, and e_new = acc - c
    within that plus one rounding of e_new itself (a scale ulp is smaller
    than an ulp of e_new wherever |acc| exceeds the scale).  fma_ref: the
    reference contracted gamma*g + e into one FMA, so its acc, and hence
    e_new, may sit one ulp of acc away everywhere."""
    w0, s0, c0, e0 = ref
    w1, s1, c1, e1 = got
    np.testing.assert_array_equal(w0.view(np.uint32), w1.view(np.uint32))
    du = ulp_diff(s0, s1)
    assert du.max() <= max_ulp, f"scale ulp {du.max()}"
    same = np.repeat(du == 0, group_size)
    tol = np.repeat(np.spacing(np.maximum(s0, s1)) * max_ulp, group_size)
    for a, b, extra in ((c0, c1, 0.0), (e0, e1, None)):
        if a is None:
            continue
        if extra is None:
            extra = np.spacing(np.maximum(np.abs(a), np.abs(b)))
            if fma_ref:
                extra = extra + np.spacing(np.abs(c0) + np.abs(e0))
        if not (fma_ref and a is e0):
            np.testing.assert_array_equal(a[same].view(np.int32),
                                          b[same].view(np.int32))
        assert np.all(np.abs(a - b) <= tol + extra)


def topk_inputs(n: int, block_size: int, k: int, seed: int,
                denormals: bool = True):
    """(g, e) f32 of length n for the block top-K wire, with adversarial
    blocks first (acc = gamma*g + e): all zeros; -0.0 everywhere; tiny
    values (denormal acc, or with denormals=False small normals);
    k + 1 equal maxima of mixed sign over small values; exactly k nonzeros;
    every |acc| equal; then random blocks of widely varying scale."""
    rng = np.random.default_rng(seed)
    B = block_size
    g = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n).astype(np.float32)
    mag = np.exp(rng.uniform(-20, 5, n // B)).astype(np.float32)
    g *= np.repeat(mag, B)
    e *= np.repeat(mag, B) * np.float32(0.01)
    blk = [slice(i * B, (i + 1) * B) for i in range(6)]
    g[blk[0]] = 0.0
    e[blk[0]] = 0.0
    g[blk[1]] = -0.0
    e[blk[1]] = -0.0
    # tiny block: with denormals=False every |acc| and every rounding
    # error of e' = acc - c stays normal (|acc| >= 2**-103), since XLA:CPU
    # flushes denormal results too
    tiny = np.float32(1.0) if denormals else np.float32(1e10)
    sgn = np.where(rng.random(B) < 0.5, -1.0, 1.0).astype(np.float32)
    g[blk[2]] = sgn * rng.uniform(1, 2, B).astype(np.float32) * 1e-40 * tiny
    e[blk[2]] = sgn * rng.uniform(1, 3, B).astype(np.float32) * 1e-41 * tiny
    ties = rng.choice(B, k + 1, replace=False)
    g[blk[3]] *= np.float32(1e-3) / np.abs(g[blk[3]]).max()
    e[blk[3]] = 0.0
    g[blk[3].start + ties] = np.where(np.arange(k + 1) % 2, -2.0, 2.0)
    g[blk[4]] = 0.0
    e[blk[4]] = 0.0
    g[blk[4].start + rng.choice(B, k, replace=False)] = \
        rng.standard_normal(k).astype(np.float32)
    g[blk[5]] = np.where(rng.random(B) < 0.5, -1.0, 1.0)
    e[blk[5]] = 0.0
    return g, e


def topk_payload(N: int, nb: int, k: int, block_size: int, seed: int):
    """Random block top-K payloads for N senders: distinct in-block indices
    (int64), values in [-1, 1] with some -0.0 and +0.0, scales with a few
    all-zero-block 1.0s, and a mask with a straggler."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((N, nb, block_size)), axis=-1)[..., :k]
    val = rng.uniform(-1, 1, (N, nb, k)).astype(np.float32)
    val[0, 0] = -0.0
    val[1, 1, :k // 2] = 0.0
    scales = np.exp(rng.uniform(-10, 2, (N, nb))).astype(np.float32)
    scales[:, 2] = 1.0
    mask = np.ones(N, np.float32)
    mask[1 % N] = 0.0
    return idx, val, scales, mask
