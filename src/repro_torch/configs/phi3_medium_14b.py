"""phi3-medium-14b [dense]: RoPE + SwiGLU + GQA.  [arXiv:2404.14219]"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=10, head_dim=128, d_ff=17920,
    vocab_size=100352, mlp="swiglu", rope_theta=10000.0)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256)

shapes, skips = lm_shapes(include_long=False)

ARCH = ArchSpec(
    arch_id="phi3-medium-14b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips)
