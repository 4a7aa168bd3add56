"""internvl2-26b [vlm]: InternViT + InternLM2 [arXiv:2404.16821]. LM backbone:
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. The vision frontend is
a STUB per the brief: input_specs() provides pre-embedded patch tokens."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553, frontend="vision", frontend_tokens=256,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, frontend="vision", frontend_tokens=8, remat="none",
    )
