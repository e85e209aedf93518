"""qwen1.5-110b [dense]: GQA with QKV bias.  [hf:Qwen/Qwen1.5-110B]

Memory plan: 110B params cannot replicate over the data axis (27.5 GB/chip
f32 at TP=16 alone), so parameters/optimizer are FSDP-sharded over 'data'
and gradient coding engages across PODS only.  On the single-pod mesh the
coding axis degenerates to 1 rank -> dense baseline (DESIGN.md Sec. 4/5).
"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=49152,
    vocab_size=152064, mlp="swiglu", qkv_bias=True, rope_theta=1000000.0)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256)

shapes, skips = lm_shapes(include_long=False)

ARCH = ArchSpec(
    arch_id="qwen1.5-110b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod",), redundancy=2, straggler_p=0.1,
                      group_size=512, fsdp=True),
    shapes=shapes, skip_shapes=skips,
    notes="FSDP over data axis; coding over pod axis (multi-pod only).")
