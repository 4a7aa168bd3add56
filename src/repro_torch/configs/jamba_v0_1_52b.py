"""jamba-v0.1-52b [hybrid]: Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]. 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536."""
from .base import MambaCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    moe=MoECfg(n_experts=16, top_k=2, d_expert_ff=14336), moe_every=2,
    mamba=MambaCfg(), attn_period=8, sub_quadratic=True,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        moe=MoECfg(n_experts=4, top_k=2, d_expert_ff=128), moe_every=2,
        mamba=MambaCfg(d_state=8, d_conv=4, expand=2), attn_period=4,
        sub_quadratic=True, remat="none",
    )
