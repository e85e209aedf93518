"""Wrapper of the attention CUDA kernels (`csrc/flash_attention_sm90.cu`,
`csrc/flash_attention.cu`).

`flash_attention(q, k, v, softcap=, window=, groups=)` keeps JAX's
signature and layout (`repro.kernels.flash_attention`): q (B, H, S, hd),
pre-scaled, k and v (B, H / groups, S, hd), f32 or bf16, output
(B, H, S, hd) in q's dtype.  For a CUDA tensor it launches a hand-written
Hopper kernel on the current stream, chosen by dtype, or raises: there is
no fallback.
- bf16 (the serve path's dtype): the tensor-core kernel (wgmma fed by TMA;
  p split into two bf16 halves for p.v).  It needs hd % 8 == 0 (TMA's
  16-byte row strides) and inputs aligned to 16 bytes.
- f32: the CUDA-core kernel (bf16 tensor cores would round the inputs).
The sharded serve (`nn.layers.attn_prefill_sharded`) calls it once a
device of the mesh with that device's query heads and the KV heads they
read, each a fresh contiguous tensor (so 16-byte aligned): one launch a
device a layer, the kernel unchanged.
Only for CPU tensors does it run the plain version
`ref.flash_attention_ref`.  The kernels take any S >= 1, hd <=
MAX_HEAD_DIM and groups >= 1; where JAX's Pallas grid drops the tail rows
of an S that is not a multiple of min(256, S), this function follows
JAX's `ref.flash_attention_ref` (ROADMAP C9).  Forward only, as JAX's
kernel is: it raises when autograd would need its gradient.  Each kernel
launch adds one to `launches["flash_attention"]` and to
`flash_routes[<route>]` and charges its bytes and operations (`cost.py`)
to the active op counters (`common.py`).  On the meta device (the dry
run's) it checks its arguments as for the card, returns an output of q's
shape and dtype and charges the counters in place of the launch, which it
does not make.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, cost, ref
from .common import VP, I, charge, check, flash_routes, launches, \
    raise_if, stream

MAX_HEAD_DIM = 288        # gemma2's head_dim; the kernels' register tiles
TMA_ALIGN = 16            # bytes: the bf16 kernel's row strides and bases
NO_WINDOW = ref.BIG_WINDOW
RTOL, ATOL = 2e-4, 2e-5   # JAX's own kernel-vs-ref tolerance (f32)
BF16_ULP = 2.0 ** -7      # one bf16 ulp of x is at most |x| * 2**-7


def allowed_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The kernel's stated tolerance against the plain version, elementwise.
    Both sum in f32 in other orders, and expf/tanhf on the card differ from
    torch's by ulps: in f32 |got - want| <= ATOL + RTOL |want| (JAX's
    `tests/test_kernels.py`); in bf16, where both round an f32 result once,
    one bf16 ulp of the larger magnitude plus ATOL."""
    a, b = got.float().abs(), want.float().abs()
    if want.dtype == torch.bfloat16:
        return BF16_ULP * torch.maximum(a, b) + ATOL
    return ATOL + RTOL * b


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`; both launchers take (q, k, v, o,
    B, H, S, hd, groups, softcap, window, stream)."""
    lib = build.library(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [VP] * 4 + [I] * 5 + [ctypes.c_float, I, VP]
    fn.restype = I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    softcap: float = 0.0, window: int = 0, groups: int = 1
                    ) -> torch.Tensor:
    """Causal GQA attention with an optional sliding window (window > 0
    keeps keys j with i - window < j <= i; 0 means global) and an optional
    tanh logit softcap (softcap > 0); exact softmax in f32."""
    if q.dim() != 4:
        raise ValueError(f"q: need (B, H, S, hd), got {tuple(q.shape)}")
    B, H, S, hd = q.shape
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: need float32 or bfloat16, got {q.dtype}")
    if groups < 1 or H % groups:
        raise ValueError(f"need H a multiple of groups (H={H}, "
                         f"groups={groups})")
    if not 1 <= hd <= MAX_HEAD_DIM or S < 1 or B < 1:
        raise ValueError(f"need B, S >= 1 and 1 <= hd <= {MAX_HEAD_DIM}, "
                         f"got {tuple(q.shape)}")
    if softcap < 0 or window < 0:
        raise ValueError(f"need softcap >= 0 and window >= 0, got "
                         f"{softcap}, {window}")
    check(q, "q", q.dtype, (B, H, S, hd), dev)
    check(k, "k", q.dtype, (B, H // groups, S, hd), dev)
    check(v, "v", q.dtype, (B, H // groups, S, hd), dev)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward only (as JAX's "
                           "kernel): run it under torch.no_grad() or "
                           "torch.inference_mode()")

    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, softcap, window, groups)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {dev}")
    bill = (cost.flash_attention, B, H, H // groups, S, hd, window,
            q.element_size())
    if q.dtype == torch.bfloat16:
        if hd % 8:
            raise ValueError(f"bf16 flash_attention on the card needs hd a "
                             f"multiple of 8 (TMA rows of 16 bytes), got "
                             f"{hd}")
        if dev.type == "cuda" and any(t.data_ptr() % TMA_ALIGN
                                      for t in (q, k, v)):
            raise ValueError("bf16 flash_attention on the card needs q, k "
                             "and v aligned to 16 bytes")
        name, route = "flash_attention_sm90", "tensor_core"
    else:
        name, route = "flash_attention", "cuda_core"
    w = min(window, NO_WINDOW) if window > 0 else NO_WINDOW
    out = torch.empty_like(q)
    if dev.type == "meta":
        charge("flash_attention", *bill)
        return out
    err = getattr(_lib(name), f"{name}_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S,
        hd, groups, float(softcap), w, stream(dev))
    raise_if(err, name)
    launches["flash_attention"] += 1
    flash_routes[route] += 1
    charge("flash_attention", *bill)
    return out
