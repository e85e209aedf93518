"""Unified model configuration covering all assigned architecture families.

The port's own copy of `repro.nn.config.ModelConfig` (same fields, same
defaults): the port imports nothing from the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | xlstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads

    # attention
    qkv_bias: bool = False
    attn_softcap: float = 0.0       # gemma2: 50.0
    final_softcap: float = 0.0      # gemma2: 30.0
    sliding_window: int = 0         # >0: window for local layers
    local_global_period: int = 0    # gemma2: 2 => alternate local/global
    rope_theta: float = 10000.0
    norm: str = "rms"               # rms | layer
    mlp: str = "swiglu"             # swiglu | geglu | relu2 | gelu

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_ff: int = 0
    moe_first_dense: int = 0        # leading dense layers (deepseek: 1)
    dense_ff: int = 0               # ff of the leading dense layers
    capacity_factor: float = 1.25

    # SSM / hybrid (mamba2 / zamba2)
    ssm_state: int = 0
    d_inner: int = 0                # 0 => 2*d_model
    ssm_heads: int = 0              # mamba2 heads; 0 => d_inner // 64
    conv_width: int = 4
    hybrid_attn_period: int = 0     # zamba2: shared attn block every k layers

    # xlstm
    slstm_every: int = 0            # one sLSTM block every k layers (0=never)
    proj_factor: float = 2.0        # xlstm block up-projection

    # input/output
    input_mode: str = "tokens"      # tokens | embeddings (musicgen/llava stubs)
    tie_embeddings: bool = False

    # numerics
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("ssm", "hybrid") and self.d_inner == 0:
            object.__setattr__(self, "d_inner", 2 * self.d_model)
        if self.family in ("ssm", "hybrid") and self.ssm_heads == 0:
            object.__setattr__(self, "ssm_heads", max(1, self.d_inner // 64))

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a reduced copy (smoke tests)."""
        return dataclasses.replace(self, **overrides)
