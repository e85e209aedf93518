"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP + LayerNorm.
[arXiv:2402.16819]"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", num_layers=32, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=24576,
    vocab_size=256000, mlp="relu2", norm="layer", rope_theta=10000.0)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256)

shapes, skips = lm_shapes(include_long=False)

ARCH = ArchSpec(
    arch_id="nemotron-4-15b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips)
