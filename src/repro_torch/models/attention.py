"""GQA attention: the port of ``repro.models.attention``.

The chunked (flash-style online-softmax) training/prefill path and the
cache-based decode path in plain PyTorch ops, with the reference's math:
scores, softmax and the value sum in f32, kv heads never repeated (GQA by
reshaping the query heads into groups). The reference computes attention
outside any Pallas kernel, so no kernel of this package replaces it.

``block_sparse_attention`` runs ``O = P @ V`` as one BSR SpMM through
``SparseOperator``, so the ambient policy picks the bsr backend (the
``bsr_spmm`` kernel on ``cuda``).

On a ``DeviceMesh`` (DTensor inputs under ``sharding_context``) the chunked
core runs in a ``local_map`` region on each rank's batch rows and heads
(:func:`_sharded_core`); the projections around it run on DTensors.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (dtensor_mesh, merge_dims, placements_for, spec_for,
                                              split_dim)

from .layers import Init, apply_rope, dense_init, rmsnorm

NEG_INF = -1e30


def init_attention(init: Init, cfg):
    hd = cfg.hd
    p = {
        "wq": dense_init(init, cfg.d_model, cfg.n_heads * hd),
        "wk": dense_init(init, cfg.d_model, cfg.n_kv_heads * hd),
        "wv": dense_init(init, cfg.d_model, cfg.n_kv_heads * hd),
        "wo": dense_init(init, cfg.n_heads * hd, cfg.d_model),
    }
    if cfg.qkv_bias:
        p["bq"] = init.zeros((cfg.n_heads * hd,))
        p["bk"] = init.zeros((cfg.n_kv_heads * hd,))
        p["bv"] = init.zeros((cfg.n_kv_heads * hd,))
    if cfg.qk_norm:
        p["q_norm"] = init.ones((hd,))
        p["k_norm"] = init.ones((hd,))
    return p


def _project_qkv(p, x, cfg, positions):
    hd = cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = split_dim(q, 2, (cfg.n_heads, hd))
    k = split_dim(k, 2, (cfg.n_kv_heads, hd))
    v = split_dim(v, 2, (cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"].to(x.dtype), cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"].to(x.dtype), cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      causal_skip: bool = False) -> torch.Tensor:
    """Online-softmax attention. q: (B,Sq,Hq,hd); k,v: (B,Skv,Hkv,hd).
    Hq % Hkv == 0 (GQA); kv heads are never materialised repeated."""
    mesh = dtensor_mesh(q)
    if mesh is not None:
        return _sharded_core(functools.partial(
            chunked_attention, causal=causal, q_offset=q_offset, q_chunk=q_chunk,
            kv_chunk=kv_chunk, causal_skip=causal_skip), q, k, v, mesh)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    # pad both sequence dims to chunk multiples; padded kv is masked off below
    Sq_p = -(-Sq // q_chunk) * q_chunk
    Skv_p = -(-Skv // kv_chunk) * kv_chunk
    if Sq_p != Sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    if Skv_p != Skv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Skv_p - Skv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Skv_p - Skv))
    nq, nk = Sq_p // q_chunk, Skv_p // kv_chunk

    # qs: (nq, B, Hkv, q_chunk, G, hd); ks/vs: (nk, B, Hkv, kv_chunk, hd[v])
    qs = q.reshape(B, nq, q_chunk, Hkv, G, hd).permute(1, 0, 3, 2, 4, 5).float()
    ks = k.reshape(B, nk, kv_chunk, Hkv, hd).permute(1, 0, 3, 2, 4).float()
    vs = v.reshape(B, nk, kv_chunk, Hkv, hdv).permute(1, 0, 3, 2, 4).float()
    qi_iota = torch.arange(q_chunk, device=dev)[:, None]
    ki_iota = torch.arange(kv_chunk, device=dev)[None, :]

    outs = []
    for qi in range(nq):
        qc = qs[qi]
        m = torch.full((B, Hkv, q_chunk, G), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, q_chunk, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, q_chunk, G, hdv), dtype=torch.float32, device=dev)
        for ki in range(nk):
            if causal and causal_skip and ki * kv_chunk > q_offset + (qi + 1) * q_chunk - 1:
                continue  # the chunk lies wholly above the causal diagonal
            s = torch.einsum("bhqgd,bhkd->bhqgk", qc, ks[ki]) * scale
            kpos = ki * kv_chunk + ki_iota
            if causal:
                qpos = q_offset + qi * q_chunk + qi_iota
                allowed = qpos >= kpos
            else:  # still mask kv padding
                allowed = (kpos < Skv).expand(q_chunk, kv_chunk)
            s = torch.where(allowed[None, None, :, None, :], s,
                            torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqgk,bhkd->bhqgd", pr, vs[ki])
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    out = torch.stack(outs)                       # (nq, B, Hkv, q_chunk, G, hdv)
    out = out.permute(1, 0, 3, 2, 4, 5).reshape(B, Sq_p, Hq, hdv)
    return out[:, :Sq]


def _sharded_core(core, q, k, v, mesh):
    """``core(q, k, v)`` in a ``local_map`` region: every rank runs it on
    its rows of the batch (split over the ``batch`` rule's axes) and, where
    the ``heads_out`` axes divide both the query and the kv heads (so that
    each rank's query heads read its own kv heads), on its heads; other
    dims whole. Attention mixes neither batch rows nor heads, so the local
    results are the global one's chunks and the gradients need no sum."""
    from torch.distributed.tensor.experimental import local_map

    axes = ("batch", None, "heads_out", None)
    sq, sk = spec_for(q.shape, axes, mesh), spec_for(k.shape, axes, mesh)
    batch = sq[0] if sq and sk and sq[0] == sk[0] else None
    heads = sq[2] if len(sq) > 2 and len(sk) > 2 and sq[2] == sk[2] else None
    pl = placements_for((batch, None, heads), mesh)
    return local_map(core, out_placements=list(pl), in_placements=(pl, pl, pl),
                     in_grad_placements=(pl, pl, pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """q: (B,1,Hq,hd); k_cache: (B,Smax,Hkv,hd); v_cache: (B,Smax,Hkv,hdv);
    pos: current index, an int or a 0-dim integer tensor on q's device.
    Attends to cache[0..pos] inclusive (the cache already holds this
    step)."""
    B, _, Hq, hd = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    hdv = v_cache.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = split_dim(q.squeeze(1), 1, (Hkv, G))
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    mask = torch.arange(Smax, device=q.device) <= pos
    s = torch.where(mask[None, None, None, :], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, hdv).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Smax, Hkv, hd)
    v: torch.Tensor


def attention_train(p, x, cfg, positions, causal=True, q_offset=0):
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                          causal_skip=getattr(cfg, "causal_skip", False))
    return merge_dims(o, 2) @ p["wo"].to(x.dtype)


def attention_prefill(p, x, cfg, positions) -> Tuple[torch.Tensor, KVCache]:
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = chunked_attention(q, k, v, causal=True)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype), KVCache(k, v)


def decode_positions(pos, B: int, device) -> torch.Tensor:
    """The decode step's ``(B, 1)`` int32 positions: ``pos`` (an int, or a
    0-dim integer tensor on ``device``) for every batch row."""
    if isinstance(pos, torch.Tensor):
        return pos.to(torch.int32).expand(B, 1)
    return torch.full((B, 1), pos, dtype=torch.int32, device=device)


def write_slot(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write the step's ``new`` ``(B, 1, ...)`` into ``cache`` ``(B, Smax,
    ...)`` at sequence index ``pos``, in place. A tensor ``pos`` goes
    through ``index_copy_`` on the device: indexing with it would read it
    on the host, which a CUDA graph's capture does not take."""
    if isinstance(pos, torch.Tensor):
        cache.index_copy_(1, pos.reshape(1).long(), new.to(cache.dtype))
    else:
        cache[:, pos] = new[:, 0].to(cache.dtype)


def attention_decode(p, x, cfg, cache: KVCache, pos) -> Tuple[torch.Tensor, KVCache]:
    """x: (B,1,D); cache pre-allocated to Smax; pos: write index, an int or
    a 0-dim integer tensor on x's device (the reference traces it). The
    cache is written in place (the reference donates it to the step)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, decode_positions(pos, B, x.device))
    write_slot(cache.k, k, pos)
    write_slot(cache.v, v, pos)
    o = decode_attention(q, cache.k, cache.v, pos)
    return o.reshape(B, 1, -1) @ p["wo"].to(x.dtype), cache


# ------------------------------------------------------- cross-attention ----

def init_cross_attention(init: Init, cfg):
    return init_attention(init, cfg)


def cross_attention(p, x, kv_src, cfg):
    """Full (non-causal) attention of x over kv_src (encoder states)."""
    hd = cfg.hd
    q = split_dim(x @ p["wq"].to(x.dtype), 2, (cfg.n_heads, hd))
    k = split_dim(kv_src @ p["wk"].to(x.dtype), 2, (cfg.n_kv_heads, hd))
    v = split_dim(kv_src @ p["wv"].to(x.dtype), 2, (cfg.n_kv_heads, hd))
    o = chunked_attention(q, k, v, causal=False)
    return merge_dims(o, 2) @ p["wo"].to(x.dtype)


def cross_attention_cached(p, x, kv_cache: KVCache, cfg):
    """Decode-side cross attention against precomputed encoder K/V."""
    B = x.shape[0]
    hd = cfg.hd
    q = split_dim(x @ p["wq"].to(x.dtype), 2, (cfg.n_heads, hd))
    o = decode_attention(q, kv_cache.k, kv_cache.v, kv_cache.k.shape[1] - 1)
    return o.reshape(B, 1, -1) @ p["wo"].to(x.dtype)


# -------------------------------------------------- block-sparse attention ----

def block_attention_bcols(seq_len: int, block_size: int,
                          pattern: str = "diag", band: int = 1) -> np.ndarray:
    """Block-column layout of a block-structured attention mask: the
    ``(nblocks, width)`` int32 ``bcols`` a :class:`BSR` takes (row block
    ``r`` may attend to the listed column blocks, ``-1`` marks pad lanes).
    ``"diag"`` is block-diagonal attention; ``"banded"`` adds ``band``
    neighbour blocks on each side."""
    if seq_len % block_size:
        raise ValueError(f"seq_len={seq_len} not divisible by block_size={block_size}")
    if pattern == "diag":
        band = 0
    elif pattern != "banded":
        raise ValueError(f"unknown pattern {pattern!r}")
    nb = seq_len // block_size
    width = 2 * band + 1
    r = np.arange(nb)[:, None]
    cols = r - band + np.arange(width)[None, :]
    return np.where((cols >= 0) & (cols < nb), cols, -1).astype(np.int32)


def block_sparse_attention(q, k, v, *, block_size: int, pattern: str = "diag",
                           band: int = 1, policy=None) -> torch.Tensor:
    """Attention under a block-diagonal/banded mask, executed as BSR SpMM.

    q: (B,S,H,hd); k: (B,S,H,hd); v: (B,S,H,hdv). Scores are computed only
    for the allowed blocks; the probability matrix becomes one batched
    block-diagonal :class:`BSR` over all (batch, head) pairs and
    ``O = P @ V`` runs through the SpMM dispatch.
    """
    from repro_torch.core.formats import BSR
    from repro_torch.core.operator import SparseOperator

    B, S, H, hd = q.shape
    hdv = v.shape[-1]
    bs = block_size
    dev = q.device
    bcols_np = block_attention_bcols(S, bs, pattern, band)   # (nb, W)
    nb, W = bcols_np.shape
    bcols = torch.from_numpy(bcols_np).to(dev)
    valid = bcols >= 0
    scale = 1.0 / math.sqrt(hd)

    qh = q.permute(0, 2, 1, 3).reshape(B * H, nb, bs, hd)
    kh = k.permute(0, 2, 1, 3).reshape(B * H, nb, bs, hd)
    vh = v.permute(0, 2, 1, 3).reshape(B * H * S, hdv)
    kg = kh[:, torch.where(valid, bcols, 0).long()]         # (BH, nb, W, bs, hd)
    s = torch.einsum("zrid,zrwjd->zrwij", qh.float(), kg.float()) * scale
    s = torch.where(valid[None, :, :, None, None], s, torch.full((), NEG_INF, device=dev))
    # softmax jointly over every key the row may attend to; the diagonal
    # block is always valid, so no row is all -inf
    sf = s.permute(0, 1, 3, 2, 4).reshape(B * H, nb, bs, W * bs)
    prob = torch.softmax(sf, dim=-1)
    blocks = prob.reshape(B * H, nb, bs, W, bs).permute(0, 1, 3, 2, 4)

    # each (batch, head) owns its own block-diagonal stripe of one container
    z = torch.arange(B * H, device=dev)[:, None, None]
    gbcols = torch.where(valid[None], bcols[None] + z * nb, -1)
    P = BSR(gbcols.reshape(B * H * nb, W).to(torch.int32).contiguous(),
            blocks.reshape(B * H * nb, W, bs, bs).contiguous(), (B * H * S, B * H * S))
    o = SparseOperator(P, policy) @ vh.float()
    return o.reshape(B, H, S, hdv).permute(0, 2, 1, 3).to(q.dtype)
