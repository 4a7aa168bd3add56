"""rwkv6-7b [ssm]: Finch, attention-free, data-dependent decay
[arXiv:2404.05892]. 32L d_model=4096 d_ff=14336 vocab=65536."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536, rwkv=True, rwkv_head_size=64, sub_quadratic=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, rwkv=True, rwkv_head_size=16,
        sub_quadratic=True, remat="none",
    )
