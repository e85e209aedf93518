"""Kernel entry points of the port.

The tensor's device decides: a CUDA tensor launches the hand-written
Hopper kernel or raises, a CPU tensor runs the plain version of `ref.py`.
Unlike `repro.kernels.ops` there is no backend knob and no fallback.  The
pack-only and top-K kernels of the JAX package (B3-B8 in ROADMAP.md) are
not ported yet.
"""
from .sign_pack import (ef_sign_fused, launches, reset_launches,  # noqa: F401
                        sign_decode_reduce)

__all__ = ["ef_sign_fused", "sign_decode_reduce", "launches",
           "reset_launches"]
