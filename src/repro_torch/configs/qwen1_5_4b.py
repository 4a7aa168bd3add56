"""qwen1.5-4b [dense]: QKV bias [hf:Qwen/Qwen1.5-4B]. 40L d_model=2560
20H (kv=20, MHA) d_ff=6912 vocab=151936. NB: 20 heads do not divide the
16-way model axis -> exercises the divisibility-fallback sharding rules."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151936, qkv_bias=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=5, head_dim=16,
        d_ff=160, vocab=256, qkv_bias=True, remat="none",
    )
