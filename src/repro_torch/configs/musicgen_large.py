"""musicgen-large [audio]: decoder-only over EnCodec tokens; the EnCodec
frontend is a STUB — input_specs() provides precomputed frame embeddings.
[arXiv:2306.05284]"""
from repro_torch.nn.config import ModelConfig
from .common import ArchSpec, CodingPlan, lm_shapes

CONFIG = ModelConfig(
    name="musicgen-large", family="dense", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048,
    mlp="gelu", norm="layer", input_mode="embeddings", rope_theta=10000.0)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      head_dim=16, d_ff=128, vocab_size=64)

shapes, skips = lm_shapes(include_long=False)

ARCH = ArchSpec(
    arch_id="musicgen-large", config=CONFIG, smoke=SMOKE,
    coding=CodingPlan(coding_axes=("pod", "data"), redundancy=2,
                      straggler_p=0.1, group_size=512),
    shapes=shapes, skip_shapes=skips,
    notes="backbone only; EnCodec frame embeddings stubbed via input_specs.")
