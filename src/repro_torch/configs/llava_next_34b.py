"""llava-next-34b [vlm]: anyres-tiling VLM; the vision tower is a STUB —
input_specs() provides precomputed patch embeddings interleaved with text.
[hf:llava-hf/llava-v1.6]"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="llava-next-34b", family="dense", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480,
    vocab_size=64000, mlp="swiglu", input_mode="embeddings",
    rope_theta=5000000.0)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256)

shapes, skips = lm_shapes(include_long=False)

ARCH = ArchSpec(
    arch_id="llava-next-34b", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips,
    notes="backbone only; anyres patch embeddings stubbed via input_specs.")
