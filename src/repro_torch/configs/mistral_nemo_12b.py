"""mistral-nemo-12b [dense]: 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1000000.0,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemo-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, remat="none",
    )
