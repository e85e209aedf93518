"""Kernel entry points of the port.

The tensor's device decides: a CUDA tensor launches the hand-written
Hopper kernel or raises, a CPU tensor runs the plain version of `ref.py`.
Unlike `repro.kernels.ops` there is no backend knob and no fallback.  The
sign-wire pack-only kernel, `block_topk` and flash attention of the JAX
package (B5, B7, B8 in ROADMAP.md) are not ported yet.
"""
from .common import launches, reset_launches  # noqa: F401
from .sign_pack import ef_sign_fused, sign_decode_reduce  # noqa: F401
from .topk_pack import (ef_topk_fused, topk_decode_reduce,  # noqa: F401
                        topk_pack)

__all__ = ["ef_sign_fused", "sign_decode_reduce", "ef_topk_fused",
           "topk_pack", "topk_decode_reduce", "launches", "reset_launches"]
