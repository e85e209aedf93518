"""xlstm-1.3b [ssm]: mLSTM + sLSTM blocks (7:1).  [arXiv:2405.04517]"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm", num_layers=48, d_model=2048,
    num_heads=4, num_kv_heads=4, d_ff=0, head_dim=512, vocab_size=50304,
    slstm_every=8, proj_factor=2.0)

SMOKE = CONFIG.scaled(num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
                      head_dim=32, vocab_size=256, slstm_every=2)

shapes, skips = lm_shapes(include_long=True)

ARCH = ArchSpec(
    arch_id="xlstm-1.3b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips,
    notes="long_500k: fully recurrent O(1)-state decode.")
