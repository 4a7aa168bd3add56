"""deepseek-v2-236b [moe]: MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]. 60L d_model=5120 128H d_expert_ff=1536 vocab=102400."""
from .base import MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,  # the single leading dense-FFN layer
    vocab=102400,
    moe=MoECfg(n_experts=160, top_k=6, d_expert_ff=1536,
               n_shared=2, d_shared_ff=3072),
    first_dense_layers=1,
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536,
               rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        moe=MoECfg(n_experts=8, top_k=2, d_expert_ff=64, n_shared=1, d_shared_ff=64),
        first_dense_layers=1,
        mla=MLACfg(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                   nope_head_dim=16, v_head_dim=16),
        remat="none",
    )
