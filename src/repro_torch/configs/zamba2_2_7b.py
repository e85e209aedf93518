"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block.
[arXiv:2411.15242]"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, head_dim=80, d_ff=10240,
    vocab_size=32000, mlp="swiglu", ssm_state=64, d_inner=5120,
    hybrid_attn_period=6, rope_theta=10000.0)

SMOKE = CONFIG.scaled(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                      head_dim=16, d_ff=128, vocab_size=256, ssm_state=8,
                      d_inner=128, ssm_heads=2, hybrid_attn_period=2)

shapes, skips = lm_shapes(include_long=True)

ARCH = ArchSpec(
    arch_id="zamba2-2.7b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips,
    notes="long_500k: O(1) SSM state decode; shared-attn blocks use full "
          "524k KV cache (9 blocks only).")
