"""olmoe-1b-7b [moe]: 64 experts, top-8.  [arXiv:2409.02060]"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1024,
    vocab_size=50304, mlp="swiglu", moe_experts=64, moe_top_k=8,
    moe_ff=1024, rope_theta=10000.0)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      head_dim=16, d_ff=64, vocab_size=256, moe_experts=8,
                      moe_top_k=2, moe_ff=64, capacity_factor=4.0)

shapes, skips = lm_shapes(include_long=False)

ARCH = ArchSpec(
    arch_id="olmoe-1b-7b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips,
    notes="experts sharded over model axis (EP); COCO-EF compresses the "
          "dense DP gradient of expert weights identically.")
