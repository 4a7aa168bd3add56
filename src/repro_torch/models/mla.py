"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the port of
``repro.models.mla``.

Train/prefill materialise per-head K/V from the compressed latent (direct
form, through ``chunked_attention``); decode uses the *absorbed* form and
caches only (c_kv, k_pe), kv_lora + rope_hd floats a token. The decode
step writes its latent into the cache in place at ``pos`` (the reference
updates a donated cache).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.distributed.sharding import merge_dims, split_dim

from .attention import NEG_INF, chunked_attention, decode_positions, write_slot
from .layers import Init, apply_rope, dense_init, rmsnorm


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, Smax, kv_lora)
    k_pe: torch.Tensor  # (B, Smax, rope_hd)


def init_mla(init: Init, cfg):
    m = cfg.mla
    H = cfg.n_heads
    qh = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": dense_init(init, cfg.d_model, m.q_lora_rank),
        "q_norm": init.ones((m.q_lora_rank,)),
        "wq_b": dense_init(init, m.q_lora_rank, H * qh),
        "wkv_a": dense_init(init, cfg.d_model, m.kv_lora_rank + m.rope_head_dim),
        "kv_norm": init.ones((m.kv_lora_rank,)),
        "wkv_b": dense_init(init, m.kv_lora_rank, H * (m.nope_head_dim + m.v_head_dim)),
        "wo": dense_init(init, H * m.v_head_dim, cfg.d_model),
    }


def _project_q(p, x, cfg, positions):
    m = cfg.mla
    H = cfg.n_heads
    cq = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"].to(x.dtype), cfg.norm_eps)
    q = split_dim(cq @ p["wq_b"].to(x.dtype), 2, (H, m.nope_head_dim + m.rope_head_dim))
    q_nope, q_pe = q[..., : m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _project_kv_latent(p, x, cfg, positions):
    m = cfg.mla
    ckv_pe = x @ p["wkv_a"].to(x.dtype)
    c_kv, k_pe = ckv_pe[..., : m.kv_lora_rank], ckv_pe[..., m.kv_lora_rank:]
    c_kv = rmsnorm(c_kv, p["kv_norm"].to(x.dtype), cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def mla_train(p, x, cfg, positions) -> torch.Tensor:
    """Direct form: expand the latent to per-head K/V, run chunked
    attention (scale 1/sqrt(nope + rope))."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_pe = _project_q(p, x, cfg, positions)
    c_kv, k_pe = _project_kv_latent(p, x, cfg, positions)
    kv = split_dim(c_kv @ p["wkv_b"].to(x.dtype), 2, (H, m.nope_head_dim + m.v_head_dim))
    k_nope, v = kv[..., : m.nope_head_dim], kv[..., m.nope_head_dim:]
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, m.rope_head_dim)], dim=-1)
    o = chunked_attention(q, k, v, causal=True)             # (B,S,H,v_hd)
    return merge_dims(o, 2) @ p["wo"].to(x.dtype)


def mla_prefill(p, x, cfg, positions) -> Tuple[torch.Tensor, MLACache]:
    out = mla_train(p, x, cfg, positions)
    c_kv, k_pe = _project_kv_latent(p, x, cfg, positions)
    return out, MLACache(c_kv, k_pe)


def mla_decode(p, x, cfg, cache: MLACache, pos) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed form: scores against the latent cache directly. x: (B,1,D);
    the step's latent is written into ``cache`` in place at ``pos`` (an int
    or a 0-dim integer tensor on x's device)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    positions = decode_positions(pos, B, x.device)
    q_nope, q_pe = _project_q(p, x, cfg, positions)         # (B,1,H,*)
    c_new, kpe_new = _project_kv_latent(p, x, cfg, positions)
    write_slot(cache.c_kv, c_new, pos)
    write_slot(cache.k_pe, kpe_new, pos)
    c_kv, k_pe = cache

    wkv_b = split_dim(p["wkv_b"].to(x.dtype), 1, (H, m.nope_head_dim + m.v_head_dim))
    wk = wkv_b[..., : m.nope_head_dim]                      # (L, H, nope)
    wv = wkv_b[..., m.nope_head_dim:]                       # (L, H, v_hd)
    # absorb: q_c[h] = q_nope[h] @ wk[:,h,:].T -> (B,H,L), in the activation dtype
    q_c = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], wk)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    s = (torch.einsum("bhl,bsl->bhs", q_c.float(), c_kv.float())
         + torch.einsum("bhr,bsr->bhs", q_pe[:, 0].float(), k_pe.float())) * scale
    mask = torch.arange(c_kv.shape[1], device=x.device) <= pos
    s = torch.where(mask[None, None, :], s, torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", w, c_kv.float())     # (B,H,L)
    o = torch.einsum("bhl,lhd->bhd", ctx.to(x.dtype), wv)   # (B,H,v_hd)
    return o.reshape(B, 1, -1) @ p["wo"].to(x.dtype), cache


def init_mla_cache(cfg, batch: int, seq: int, dtype, device) -> MLACache:
    m = cfg.mla
    return MLACache(torch.zeros((batch, seq, m.kv_lora_rank), dtype=dtype, device=device),
                    torch.zeros((batch, seq, m.rope_head_dim), dtype=dtype, device=device))
