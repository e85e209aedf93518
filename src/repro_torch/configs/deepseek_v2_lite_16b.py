"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 2 shared / 64 routed
top-6 experts, first layer dense.  [arXiv:2405.04434]

Note: the assignment brief lists both "MoE 64e top-6" and "160 routed";
DeepSeek-V2-Lite has 64 routed experts (2 shared, top-6) — we follow the
64e figure (DESIGN.md).
"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="deepseek", num_layers=27,
    d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408,
    vocab_size=102400, mlp="swiglu", mla=True, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, moe_experts=64,
    moe_top_k=6, moe_shared=2, moe_ff=1408, moe_first_dense=1,
    dense_ff=10944, rope_theta=10000.0)

SMOKE = CONFIG.scaled(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
                      head_dim=16, d_ff=64, vocab_size=256, kv_lora_rank=32,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                      moe_experts=8, moe_top_k=2, moe_shared=1, moe_ff=64,
                      dense_ff=128, capacity_factor=4.0)

shapes, skips = lm_shapes(include_long=False)
skips["long_500k"] = ("MLA is still full (latent-compressed) attention: "
                      "524k decode is O(T) per token per layer — skipped "
                      "per the pure-full-attention rule")

ARCH = ArchSpec(
    arch_id="deepseek-v2-lite-16b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips)
