"""The port's cache builders from a whole prompt, `repro_torch.nn.layers.
prefill_kv` (GQA rings) and `mla_prefill` (MLA latent rings), against
JAX's `repro.nn.layers` on the CPU: prompts shorter than the ring, as
long, and longer (S = 5, 8, 13 against 8 slots), f32 and bf16 compute,
bf16 and f32 caches, on gemma2-2b's, qwen1.5-110b's (qkv bias) and
deepseek-v2-lite-16b's (MLA) smoke widths.

Tolerances and why: `pos` exactly (the slots' positions, -BIG_WINDOW where
empty, JAX's stable sort by ring slot, which repeats positions when S is
shorter than the ring); a bf16 cache within one bf16 ulp of the larger
magnitude, elementwise (each package rounds its own f32 or bf16 k, v or
latent once: 0 seen); an f32 cache of f32 compute at JAX's own f32
tolerance (`test_torch_families.assert_close`: rtol 1e-5, atol 1e-6 at
unit scale; 4.8e-7 seen); an f32 cache of bf16 compute holds bf16 values,
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import one_thread
from repro.configs import REGISTRY as JREG
from repro.nn import layers as JL
from repro_torch.configs import REGISTRY
from repro_torch.nn import layers as L
from test_torch_families import assert_close

RING = 8
CASES = {"gemma2-2b": "kv", "qwen1.5-110b": "kv",
         "deepseek-v2-lite-16b": "mla"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _bf16_ulp_apart(got: np.ndarray, want: np.ndarray) -> bool:
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    return bool(np.all(np.abs(got - want) <= ulp))


@pytest.mark.parametrize("arch", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_from_prompt_matches_jax(arch, dtype):
    mla = CASES[arch] == "mla"
    cfg = REGISTRY[arch].smoke.scaled(dtype=dtype)
    jcfg = JREG[arch].smoke.scaled(dtype=dtype)
    init = JL.init_mla if mla else JL.init_attention
    p = jax.jit(lambda k: init(k, jcfg))(jax.random.PRNGKey(1))
    pt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, jcfg.param_dtype)) for k, v in p.items()}
    jfn, fn = ((JL.mla_prefill, L.mla_prefill) if mla
               else (JL.prefill_kv, L.prefill_kv))
    for S in (5, RING, 13):
        x = np.random.default_rng(S).standard_normal(
            (2, S, jcfg.d_model)).astype(np.float32)
        xj = jnp.asarray(x).astype(jnp.dtype(dtype))
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        for cache in ("bfloat16", "float32"):
            want = jax.jit(lambda p, x: jfn(p, x, jcfg, RING,
                                            jnp.dtype(cache)))(p, xj)
            got = fn(pt, xt, cfg, RING, getattr(torch, cache))
            assert sorted(got) == sorted(want)
            np.testing.assert_array_equal(got["pos"].numpy(),
                                          np.asarray(want["pos"]))
            assert got["pos"].dtype == torch.int32
            for k in got:
                if k == "pos":
                    continue
                assert got[k].dtype == getattr(torch, cache)
                g = got[k].float().numpy()
                w = np.asarray(want[k].astype(jnp.float32))
                assert g.shape == w.shape, (k, S)
                if cache == "bfloat16":
                    assert _bf16_ulp_apart(g, w), (k, S)
                elif dtype == "bfloat16":
                    np.testing.assert_array_equal(g, w)
                else:
                    assert_close(got[k], w, "float32", f"{k} S={S}")


def test_short_prompt_layout_is_jax_sort():
    """S < ring: slots ordered by the stable sort of arange(T) % S, so the
    first S slots hold positions 0, 0, 0, 1, 1, 1, 2, 2 cut to S."""
    cfg = REGISTRY["gemma2-2b"].smoke.scaled(dtype="float32")
    jcfg = JREG["gemma2-2b"].smoke.scaled(dtype="float32")
    p = jax.jit(lambda k: JL.init_attention(k, jcfg))(jax.random.PRNGKey(1))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, cfg.d_model)).astype(np.float32))
    got = L.prefill_kv(pt, x, cfg, RING)
    assert got["pos"].tolist() == [0, 0, 0] + [-L.BIG_WINDOW] * 5
    assert got["k"].dtype == torch.bfloat16
