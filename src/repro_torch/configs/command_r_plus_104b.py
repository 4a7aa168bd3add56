"""command-r-plus-104b [dense]: GQA, no-bias [hf:CohereForAI/c4ai-command-r].
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000, rope_theta=75000000.0,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=512, remat="none",
    )
