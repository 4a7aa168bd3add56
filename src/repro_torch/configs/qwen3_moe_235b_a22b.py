"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, qk-norm
[hf:Qwen/Qwen3-235B-A22B]. 94L d_model=4096 64H (GQA kv=4) d_expert_ff=1536
vocab=151936."""
from .base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, qk_norm=True, rope_theta=1000000.0,
    moe=MoECfg(n_experts=128, top_k=8, d_expert_ff=1536),
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qk_norm=True,
        moe=MoECfg(n_experts=8, top_k=2, d_expert_ff=64),
        remat="none",
    )
