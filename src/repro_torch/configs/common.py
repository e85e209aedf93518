"""ArchSpec: one architecture + its shape set + coding plan (port's copy of
`repro.configs.common`, restricted to what the one-card slice uses)."""
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


@dataclasses.dataclass(frozen=True)
class CodingPlan:
    """How COCO-EF engages for this arch.

    coding_axes: the JAX mesh axes the coding ranks live on (kept so a
      spec reads the same in both packages; the one-card slice puts every
      coding rank on the same device).
    redundancy: d_k — how many coding ranks hold each data subset.
    straggler_p: Bernoulli straggler probability baked into encode weights.
    group_size: sign-quantization group.
    compressor: phase-1 wire compressor; the port carries "sign" and
      "block_topk".
    k_per_block / block_size: block top-K sparsification parameters
      (compressor="block_topk").
    topk_k: global top-K budget (compressor="topk", not ported yet).
    wire_dtype: sparse-value dtype on the wire.
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


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    coding: CodingPlan
    shapes: Dict[str, ShapeCfg] = dataclasses.field(default_factory=dict)
