"""llama3.2-1b [dense] [hf:meta-llama/Llama-3.2-1B].
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256, rope_theta=500000.0, tie_embeddings=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, tie_embeddings=True, remat="none",
    )
