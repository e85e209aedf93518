"""Architecture registry of the port: the dense and MoE families of
`repro.configs` (the MLA, hybrid and xLSTM specs are still to port)."""
from . import (gemma2_2b, llava_next_34b, musicgen_large, nemotron4_15b,
               olmoe_1b_7b, phi3_medium_14b, qwen15_110b)
from .common import ArchSpec, CodingPlan, ShapeCfg  # noqa: F401

REGISTRY = {m.ARCH.arch_id: m.ARCH for m in (
    gemma2_2b, phi3_medium_14b, qwen15_110b, nemotron4_15b, olmoe_1b_7b,
    musicgen_large, llava_next_34b)}
