"""Wrappers of the sign-wire CUDA kernels (`csrc/sign_pack.cu`).

For a CUDA tensor a wrapper launches its hand-written Hopper kernel on the
current stream, or raises: there is no fallback.  Only for CPU tensors does
it run the plain version in `ref.py`.  Each kernel launch adds one to
`launches[<name>]` and charges its bytes and operations (`cost.py`) to the
active op counters (`common.charge`).  On the meta device (the dry run's)
a wrapper checks its arguments as for the card, returns outputs of the
kernel's shapes and dtypes, and charges the counters in place of the
launch, which it does not make.

`ef_sign_fused` has an instance for each (g dtype, e dtype) in DTYPES^2
(bf16 g: the gradient of bf16 parameters; bf16 e: TrainRun.ef_dtype) and
`sign_pack` one for each x dtype in DTYPES; a CUDA tensor of another dtype
raises TypeError.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build, cost, ref
from .common import (DTYPES, LL, VP, I, charge, check,  # noqa: F401
                     check_dtype, dtype_code, launches, raise_if,
                     reset_launches, scalar, stream)

SUPPORTED_GROUP_SIZES = (32, 64, 128, 256, 512, 1024)   # see SIGN_DISPATCH


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("sign_pack")
    lib.ef_sign_fused_launch.argtypes = [VP] * 8 + [LL, I, I, VP]
    lib.ef_sign_fused_launch.restype = I
    lib.sign_pack_launch.argtypes = [VP] * 4 + [LL, I, I, VP]
    lib.sign_pack_launch.restype = I
    lib.sign_decode_reduce_launch.argtypes = [VP] * 4 + [I, LL, I, VP]
    lib.sign_decode_reduce_launch.restype = I
    return lib


def _check_group(n: int, group_size: int, device: torch.device) -> None:
    if group_size % 32 or n % group_size or n <= 0:
        raise ValueError(f"need group_size % 32 == 0 and n a positive "
                         f"multiple of group_size (n={n}, g={group_size})")
    if device.type in ("cuda", "meta") and \
            group_size not in SUPPORTED_GROUP_SIZES:
        raise ValueError(f"no CUDA kernel for group_size={group_size}; "
                         f"have {SUPPORTED_GROUP_SIZES}")


def ef_sign_fused(g: torch.Tensor, e: torch.Tensor, gamma, mask_self,
                  group_size: int, want_c: bool = False,
                  out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]] = None):
    """Fused local COCO-EF step on the sign wire, one pass over g and e:
    acc = gamma*g + e; words/scales = sign_pack(acc); c = sign(acc)*scale;
    e_new = mask_self > 0 ? acc - c : e.

    g, e: (n,) f32 or bf16, widened in registers; gamma, mask_self:
    scalars (floats or one-element tensors).  The CUDA kernel reads both from device memory: a tensor on
    the device costs nothing, a float or a CPU tensor one copy to the
    device per launch, which blocks the host (the train step therefore
    makes gamma a device scalar once per step).
    `out` = (words (n/32,) u32, scales (n/g,) f32, e_new (n,) in e's
    dtype) to write into; e_new may be `e` itself (the update is safe in
    place).  A bf16 e_new is the f32 value rounded once.  Returns (words,
    scales, c (f32) or None, e_new)."""
    n = g.numel()
    dev = g.device
    _check_group(n, group_size, dev)
    check_dtype(g, "g")
    check_dtype(e, "e")
    check(g, "g", g.dtype, (n,), dev)
    check(e, "e", e.dtype, (n,), dev)
    if out is None:
        out = (torch.empty(n // 32, dtype=torch.uint32, device=dev),
               torch.empty(n // group_size, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=e.dtype, device=dev))
    words, scales, e_new = out
    check(words, "words", torch.uint32, (n // 32,), dev)
    check(scales, "scales", torch.float32, (n // group_size,), dev)
    check(e_new, "e_new", e.dtype, (n,), dev)
    gamma_t, mask_t = scalar(gamma, dev), scalar(mask_self, dev)

    if dev.type == "cpu":
        w, s, c, en = ref.ef_sign_fused_ref(g, e, gamma_t, mask_t,
                                            group_size)
        words.copy_(w)
        scales.copy_(s)
        e_new.copy_(en)
        return words, scales, (c if want_c else None), e_new
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"ef_sign_fused: unsupported device {dev}")
    c = torch.empty(n, dtype=torch.float32, device=dev) if want_c else None
    bill = (cost.ef_sign_fused, n, group_size, g.element_size(),
            e.element_size())
    if dev.type == "meta":
        charge("ef_sign_fused", *bill)
        return words, scales, c, e_new
    err = _lib().ef_sign_fused_launch(
        g.data_ptr(), e.data_ptr(), gamma_t.data_ptr(), mask_t.data_ptr(),
        words.data_ptr(), scales.data_ptr(),
        c.data_ptr() if c is not None else None, e_new.data_ptr(),
        n, group_size, dtype_code(g, e), stream(dev))
    raise_if(err, "ef_sign_fused")
    launches["ef_sign_fused"] += 1
    charge("ef_sign_fused", *bill)
    return words, scales, c, e_new


def sign_pack(x: torch.Tensor, group_size: int,
              out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              gamma=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack only: x (n,) f32 or bf16, acc = gamma * x rounded once in f32
    (acc = x when gamma is None) -> (words (n/32,) u32 with bit j of word
    w = acc[32w+j] >= 0, scales (n/g,) f32 = mean |acc| per group, summed
    in `ref.group_abs_mean`'s order), written into `out` = (words, scales)
    when given.  gamma is COCO's step size, folded into the pack so that
    the step neither rewrites g nor widens it into a copy."""
    n, dev = x.numel(), x.device
    _check_group(n, group_size, dev)
    check_dtype(x, "x")
    check(x, "x", x.dtype, (n,), dev)
    if out is None:
        out = (torch.empty(n // 32, dtype=torch.uint32, device=dev),
               torch.empty(n // group_size, dtype=torch.float32, device=dev))
    words, scales = out
    check(words, "words", torch.uint32, (n // 32,), dev)
    check(scales, "scales", torch.float32, (n // group_size,), dev)

    gamma_t = None if gamma is None else scalar(gamma, dev)
    if dev.type == "cpu":
        w, s = ref.sign_pack_ref(x, group_size, gamma_t)
        words.copy_(w)
        scales.copy_(s)
        return words, scales
    bill = (cost.sign_pack, n, group_size, x.element_size())
    if dev.type == "meta":
        charge("sign_pack", *bill)
        return words, scales
    if dev.type != "cuda":
        raise ValueError(f"sign_pack: unsupported device {dev}")
    err = _lib().sign_pack_launch(
        x.data_ptr(), None if gamma_t is None else gamma_t.data_ptr(),
        words.data_ptr(), scales.data_ptr(), n, group_size,
        int(x.dtype == torch.bfloat16), stream(dev))
    raise_if(err, "sign_pack")
    launches["sign_pack"] += 1
    charge("sign_pack", *bill)
    return words, scales


def sign_decode_reduce(words: torch.Tensor, scales: torch.Tensor,
                       mask: torch.Tensor, group_size: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Server-side decode + masked sum over senders, in sender order:
    words (N, n/32) u32, scales (N, n/g) f32, mask (N,) f32 -> (n,) f32,
    written into `out` when given."""
    dev = words.device
    if words.dim() != 2:
        raise ValueError(f"words: need (N, n/32), got {tuple(words.shape)}")
    N, nw = words.shape
    n = nw * 32
    _check_group(n, group_size, dev)
    check(words, "words", torch.uint32, (N, nw), dev)
    check(scales, "scales", torch.float32, (N, n // group_size), dev)
    check(mask, "mask", torch.float32, (N,), dev)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=dev)
    check(out, "out", torch.float32, (n,), dev)

    if dev.type == "cpu":
        return out.copy_(ref.sign_decode_reduce_ref(words, scales, mask,
                                                    group_size))
    bill = (cost.sign_decode_reduce, N, n, group_size)
    if dev.type == "meta":
        charge("sign_decode_reduce", *bill)
        return out
    if dev.type != "cuda":
        raise ValueError(f"sign_decode_reduce: unsupported device {dev}")
    if out.data_ptr() % 16:
        raise ValueError("out: the kernel stores float4, need 16-byte "
                         "alignment")
    err = _lib().sign_decode_reduce_launch(
        words.data_ptr(), scales.data_ptr(), mask.data_ptr(),
        out.data_ptr(), N, n, group_size, stream(dev))
    raise_if(err, "sign_decode_reduce")
    launches["sign_decode_reduce"] += 1
    charge("sign_decode_reduce", *bill)
    return out
