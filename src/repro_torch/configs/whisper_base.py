"""whisper-base [audio]: enc-dec, conv frontend STUB (pre-embedded frames per
the brief) [arXiv:2212.04356]. 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab=51865, frontend="audio", frontend_tokens=1500,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, frontend="audio", frontend_tokens=16,
        remat="none",
    )
