"""Kernel entry points of the port.

The tensor's device decides: a CUDA tensor launches the hand-written
Hopper kernel or raises, a CPU tensor runs the plain version of `ref.py`.
Unlike `repro.kernels.ops` there is no backend knob and no fallback.
Every Pallas kernel of the JAX package has its counterpart here.
"""
from .common import launches, reset_launches  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .sign_pack import (ef_sign_fused, sign_decode_reduce,  # noqa: F401
                        sign_pack)
from .topk_pack import (block_topk, ef_topk_fused,  # noqa: F401
                        topk_decode_reduce, topk_pack)

__all__ = ["ef_sign_fused", "sign_pack", "sign_decode_reduce",
           "ef_topk_fused", "topk_pack", "topk_decode_reduce", "block_topk",
           "flash_attention", "launches", "reset_launches"]
