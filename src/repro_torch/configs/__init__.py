"""Architecture registry of the port: every arch of `repro.configs` (the
dense, MoE, deepseek (MLA), hybrid (Mamba2) and xLSTM families)."""
from . import (deepseek_v2_lite_16b, gemma2_2b, llava_next_34b,
               musicgen_large, nemotron4_15b, olmoe_1b_7b, phi3_medium_14b,
               qwen15_110b, xlstm_1_3b, zamba2_2_7b)
from .common import ArchSpec, CodingPlan, ShapeCfg  # noqa: F401

REGISTRY = {m.ARCH.arch_id: m.ARCH for m in (
    gemma2_2b, phi3_medium_14b, qwen15_110b, nemotron4_15b, olmoe_1b_7b,
    musicgen_large, llava_next_34b, deepseek_v2_lite_16b, zamba2_2_7b,
    xlstm_1_3b)}
