"""Model/config schema shared by all assigned architectures: the port's
copy of ``repro.configs.base``, field for field.

Every architecture in ``repro_torch/configs/<id>.py`` exposes:
    CONFIG        : full-size ModelConfig (exact assignment numbers)
    smoke_config(): reduced same-family config for CPU smoke tests

``activation_dtype`` is a ``torch.dtype``; the parameter counts go through
the port's ``models.count_params_struct``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0            # shared (always-on) experts, deepseek-style
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    dispatch_impl: str = "sort"  # 'sort' | 'onehot' | 'coo' | 'bsr' | 'grouped'
    n_groups: int = 0            # grouped dispatch: 0 = auto (DP degree)


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False                   # qwen3-style per-head RMSNorm
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    moe_every: int = 1                      # apply MoE FFN every k-th layer
    first_dense_layers: int = 0             # deepseek: leading dense-FFN layers
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    attn_period: int = 0                    # jamba: 1 attn per `attn_period` layers
    rwkv: bool = False
    rwkv_head_size: int = 64
    encoder_layers: int = 0                 # enc-dec (whisper)
    frontend: str = "none"                  # none | vision | audio (STUBS)
    frontend_tokens: int = 0                # patches / frames provided pre-embedded
    sub_quadratic: bool = False             # supports long_500k
    dtype: str = "bfloat16"
    # --- non-architectural knobs the launcher may override ---
    remat: str = "full"                     # full | dots | none
    microbatch: int = 0                     # 0 = auto
    seq_parallel: bool = False              # Megatron-SP residual sharding
    causal_skip: bool = False               # skip fully-masked kv chunks
    fsdp: bool = False                      # shard params/opt over data axis
                                            # (ZeRO-3: the embed dim of every
                                            # weight shards over 'data')
    zero: bool = False                      # mixed-precision ZeRO: bf16 compute
                                            # params (TP-sharded), f32 master +
                                            # moments FSDP-sharded over data,
                                            # per-microbatch grad reduce-scatter

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------- parameter / FLOP accounting (roofline §) -------------

    def param_count(self) -> int:
        """Exact-ish parameter count from the architecture tables."""
        from repro_torch.models.model import count_params_struct
        return count_params_struct(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_struct
        return count_params_struct(self, active_only=True)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Is (arch x shape) runnable? long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "quadratic full attention at 524k seq (per brief: skip, see DESIGN.md)"
    return True, ""
