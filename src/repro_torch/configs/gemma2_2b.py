"""gemma2-2b [dense]: local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]  Same numbers as `repro.configs.gemma2_2b`."""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense", num_layers=26, d_model=2304,
    num_heads=8, num_kv_heads=4, head_dim=288, d_ff=9216, vocab_size=256000,
    mlp="geglu", attn_softcap=50.0, final_softcap=30.0,
    sliding_window=4096, local_global_period=2, tie_embeddings=True,
    rope_theta=10000.0)

SMOKE = CONFIG.scaled(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256, sliding_window=8)

# long_500k runs with ALL layers window-capped (ring caches): the local half
# is faithful; capping the global half is a documented deviation (DESIGN.md).
shapes, skips = lm_shapes(include_long=True)

ARCH = ArchSpec(
    arch_id="gemma2-2b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips,
    notes="long_500k: global layers window-capped to 4096 (ring cache); "
          "sliding-window half is faithful sub-quadratic.")
