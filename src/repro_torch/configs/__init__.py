"""Architecture registry of the port: every arch of `repro.configs` (the
dense, MoE, deepseek (MLA), hybrid (Mamba2) and xLSTM families), in
JAX's registry order, so `all_cells` lists the cells as JAX's does."""
from . import (deepseek_v2_lite_16b, gemma2_2b, llava_next_34b,
               musicgen_large, nemotron4_15b, olmoe_1b_7b, phi3_medium_14b,
               qwen15_110b, xlstm_1_3b, zamba2_2_7b)
from .common import (ArchSpec, CodingPlan, ShapeCfg,  # noqa: F401
                     STANDARD_SHAPES)

REGISTRY = {m.ARCH.arch_id: m.ARCH for m in (
    gemma2_2b, phi3_medium_14b, qwen15_110b, nemotron4_15b, zamba2_2_7b,
    xlstm_1_3b, olmoe_1b_7b, deepseek_v2_lite_16b, musicgen_large,
    llava_next_34b)}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells():
    """Every (arch, shape name, ShapeCfg or None, skip reason or None)
    cell, skipped ones included, in JAX's order."""
    for aid, spec in REGISTRY.items():
        for sname in STANDARD_SHAPES:
            if sname in spec.skip_shapes:
                yield aid, sname, None, spec.skip_shapes[sname]
            elif sname in spec.shapes:
                yield aid, sname, spec.shapes[sname], None
