"""ArchSpec: one architecture + its shape set + coding plan (the port's copy
of `repro.configs.common`)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.nn.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeCfg("train", 4096, 256)
PREFILL_32K = ShapeCfg("prefill", 32768, 32)
DECODE_32K = ShapeCfg("decode", 32768, 128)
LONG_500K = ShapeCfg("decode", 524288, 1)


@dataclasses.dataclass(frozen=True)
class CodingPlan:
    """How COCO-EF engages for this arch.

    coding_axes: the JAX mesh axes the coding ranks live on (kept so a
      spec reads the same in both packages; the port puts every coding
      rank on one device, or one rank per process of a coding grid).
    redundancy: d_k — how many coding ranks hold each data subset.
    straggler_p: Bernoulli straggler probability baked into encode weights.
    group_size: sign-quantization group.
    compressor: phase-1 wire compressor (sign | block_topk | topk |
      identity).
    k_per_block / block_size: block top-K sparsification parameters
      (compressor="block_topk").
    topk_k: global top-K budget (compressor="topk").
    wire_dtype: sparse-value / dense-payload dtype on the wire.
    fsdp: JAX shards this arch's parameters over the 'data' axis too and
      codes over 'pod' only (qwen1.5-110b); the port keeps it as data.
    """

    coding_axes: Tuple[str, ...] = ("pod", "data")
    redundancy: int = 2
    straggler_p: float = 0.1
    group_size: int = 512
    compressor: str = "sign"
    k_per_block: int = 8
    block_size: int = 256
    topk_k: int = 64
    wire_dtype: str = "float32"
    fsdp: bool = False


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    coding: CodingPlan
    shapes: Dict[str, ShapeCfg] = dataclasses.field(default_factory=dict)
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""


def lm_shapes(include_long: bool, long_reason: str = "",
              include_decode: bool = True) -> Tuple[Dict, Dict]:
    """(shapes, skipped shapes with their reasons) of an LM arch."""
    shapes = {"train_4k": TRAIN_4K, "prefill_32k": PREFILL_32K}
    skips = {}
    if include_decode:
        shapes["decode_32k"] = DECODE_32K
    if include_long:
        shapes["long_500k"] = LONG_500K
    else:
        skips["long_500k"] = long_reason or (
            "pure full-attention arch: 524k dense-KV decode is "
            "quadratic-cost by design (assignment rule)")
    return shapes, skips
