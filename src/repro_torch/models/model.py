"""Model assembly: config -> (init, train loss, prefill, decode), the port of
``repro.models.model`` for the attention families.

Layer stacks are kept as the reference keeps them: each group's parameters
are stacked along a leading layer axis (``params["groups"][g]``, every leaf
``(n, ...)``), and caches are stacked the same way. The reference scans over
that axis; here a Python loop walks it, one layer at a time, and the decode
step writes each layer's cache slice in place (the reference donates the
caches to the step).

  dense/vlm    : [attn+mlp] x L
  moe (qwen3)  : [attn+moe] x L

Not ported yet (ROADMAP queue 1, item 9): the MLA mixer (deepseek), the
Mamba and Jamba blocks (``ssm.py``), RWKV (``rwkv.py``) and the
encoder-decoder ``EncDecLM`` (whisper); each raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import resolve_device
from repro_torch.distributed.sharding import logical_constraint

from . import attention as attn
from . import moe as moe_mod
from .layers import Init, apply_mlp, dense_init, embed_init, init_mlp, rmsnorm

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 9)"


class GroupDef(NamedTuple):
    name: str
    n: int
    init: Callable          # init -> single-layer params
    train: Callable         # (lp, x, ctx) -> (x, aux)
    prefill: Callable       # (lp, x, ctx) -> (x, cache_l, aux)
    decode: Callable        # (lp, x, cache_l, pos, ctx) -> (x, cache_l)
    init_cache: Callable    # (batch, seq, dtype, device) -> cache_l (zeros)


# ------------------------------------------------------------ block defs ----

def _ffn_init(init: Init, cfg, use_moe: bool):
    if use_moe:
        return moe_mod.init_moe(init, cfg, cfg.moe)
    return init_mlp(init, cfg.d_model, cfg.d_ff)


def _ffn_apply(lp_ffn, x, cfg, use_moe: bool):
    if use_moe:
        B, S, D = x.shape
        y, aux = moe_mod.moe_ffn(lp_ffn, x.reshape(B * S, D), cfg, cfg.moe)
        return y.reshape(B, S, D), aux
    return apply_mlp(lp_ffn, x), torch.zeros((), dtype=torch.float32, device=x.device)


def attn_block(cfg: ModelConfig, use_moe: bool, use_mla: bool, name: str) -> GroupDef:
    if use_mla:
        raise NotImplementedError(f"the MLA mixer of {cfg.name} {_NOT_PORTED}")

    def init(ini: Init):
        return {
            "ln1": ini.ones((cfg.d_model,)),
            "mixer": attn.init_attention(ini, cfg),
            "ln2": ini.ones((cfg.d_model,)),
            "ffn": _ffn_init(ini, cfg, use_moe),
        }

    def train(lp, x, ctx):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        x = x + attn.attention_train(lp["mixer"], h, cfg, ctx["positions"])
        seq_ax = "seq_act" if cfg.seq_parallel else None
        x = logical_constraint(x, ("batch", seq_ax, None))
        f = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y, aux = _ffn_apply(lp["ffn"], f, cfg, use_moe)
        return x + y, aux

    def prefill(lp, x, ctx):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        h, cache = attn.attention_prefill(lp["mixer"], h, cfg, ctx["positions"])
        x = x + h
        f = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y, aux = _ffn_apply(lp["ffn"], f, cfg, use_moe)
        return x + y, cache, aux

    def decode(lp, x, cache, pos, ctx):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        h, cache = attn.attention_decode(lp["mixer"], h, cfg, cache, pos)
        x = x + h
        f = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y, _ = _ffn_apply(lp["ffn"], f, cfg, use_moe)
        return x + y, cache

    def init_cache(batch, seq, dtype, device):
        shape = (batch, seq, cfg.n_kv_heads, cfg.hd)
        return attn.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                            torch.zeros(shape, dtype=dtype, device=device))

    return GroupDef(name, 0, init, train, prefill, decode, init_cache)


def mamba_block(cfg: ModelConfig, use_moe: bool, name: str) -> GroupDef:
    raise NotImplementedError(f"the Mamba block of {cfg.name} {_NOT_PORTED}")


def rwkv_block(cfg: ModelConfig, name: str) -> GroupDef:
    raise NotImplementedError(f"the RWKV block of {cfg.name} {_NOT_PORTED}")


def jamba_period(cfg: ModelConfig, name: str) -> GroupDef:
    raise NotImplementedError(f"the Jamba period of {cfg.name} {_NOT_PORTED}")


# -------------------------------------------------------------- assembly ----

def build_groups(cfg: ModelConfig) -> List[GroupDef]:
    if cfg.rwkv:
        return [rwkv_block(cfg, "rwkv")._replace(n=cfg.n_layers)]
    if cfg.attn_period:  # jamba
        return [jamba_period(cfg, "period")._replace(n=cfg.n_layers // cfg.attn_period)]
    use_mla = cfg.mla is not None
    groups = []
    if cfg.moe is not None:
        nd = cfg.first_dense_layers
        if nd:
            groups.append(attn_block(cfg, False, use_mla, "dense_head")._replace(n=nd))
        groups.append(attn_block(cfg, True, use_mla, "moe_body")._replace(n=cfg.n_layers - nd))
    else:
        groups.append(attn_block(cfg, False, use_mla, "body")._replace(n=cfg.n_layers))
    return groups


def _stack_init(gdef: GroupDef, init: Init):
    """``gdef.n`` layers drawn one after another, each leaf stacked along a
    leading layer axis."""
    layers = [gdef.init(init) for _ in range(gdef.n)]
    return _stack(layers)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(layer(v, i) for v in tree))
    return tree[i]


@dataclass
class LM:
    """Decoder-only LM (plus the vision prefix stub for the vlm family) on
    ``device`` (default the card; ``"cpu"`` to run on the host)."""

    cfg: ModelConfig
    device: Any = "cuda"

    def __post_init__(self):
        self.groups = build_groups(self.cfg)
        if torch.device(self.device).type != "meta":
            self.device = resolve_device(self.device)

    # ------------------------------------------------------------ params --

    def init(self, generator=0, weight_dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Parameters drawn from ``generator`` (a ``torch.Generator`` on the
        model's device, or a seed for one). ``weight_dtype`` is f32, the
        reference's; a server may keep every weight but the router in the
        activation dtype instead, the values the reference's per-use casts
        give, at half the bytes."""
        cfg = self.cfg
        if isinstance(generator, int) and torch.device(self.device).type != "meta":
            generator = torch.Generator(device=self.device).manual_seed(generator)
        ini = Init(generator if isinstance(generator, torch.Generator) else None,
                   self.device, weight_dtype)
        params: Dict[str, Any] = {
            "embed": embed_init(ini, cfg.vocab, cfg.d_model),
            "norm_f": ini.ones((cfg.d_model,)),
            "groups": [_stack_init(g, ini) for g in self.groups],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(ini, cfg.d_model, cfg.vocab, scale=0.02)
        if cfg.frontend == "vision":
            params["frontend_proj"] = dense_init(ini, cfg.d_model, cfg.d_model)
        return params

    # ----------------------------------------------------------- helpers --

    def _embed(self, params, tokens):
        x = params["embed"][tokens.long()].to(self.cfg.activation_dtype)
        return logical_constraint(x, ("batch", None, None))

    def _prefix(self, params, extra):
        """Vision stub: pre-embedded patches projected and prepended."""
        if self.cfg.frontend == "vision" and extra is not None and "patches" in extra:
            pe = extra["patches"].to(self.cfg.activation_dtype)
            return pe @ params["frontend_proj"].to(pe.dtype)
        return None

    def _head(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        logits = x @ w.to(x.dtype)
        return logical_constraint(logits, ("batch", None, "vocab"))

    def _positions(self, B: int, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device)[None].expand(B, S)

    # ------------------------------------------------------------- modes --

    def forward_train(self, params, tokens, extra=None):
        """tokens: (B,S) -> logits (B,S,V) [token positions only], aux."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        prefix = self._prefix(params, extra)
        P = 0
        if prefix is not None:
            P = prefix.shape[1]
            x = torch.cat([prefix, x], dim=1)
        B, S = x.shape[:2]
        ctx = {"positions": self._positions(B, S)}
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for g, gp in zip(self.groups, params["groups"]):
            for i in range(g.n):
                x, aux = g.train(layer(gp, i), x, ctx)
                aux_total = aux_total + aux
        x = rmsnorm(x, params["norm_f"].to(x.dtype), cfg.norm_eps)
        return self._head(params, x[:, P:]), aux_total

    def prefill(self, params, tokens, extra=None):
        """-> (last-position logits (B,V), caches, next_pos)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        prefix = self._prefix(params, extra)
        if prefix is not None:
            x = torch.cat([prefix, x], dim=1)
        B, S = x.shape[:2]
        ctx = {"positions": self._positions(B, S)}
        caches = []
        for g, gp in zip(self.groups, params["groups"]):
            per_layer = []
            for i in range(g.n):
                x, cache, _ = g.prefill(layer(gp, i), x, ctx)
                per_layer.append(cache)
            caches.append(type(per_layer[0])(*(torch.stack(t) for t in zip(*per_layer))))
        x = rmsnorm(x, params["norm_f"].to(x.dtype), cfg.norm_eps)
        return self._head(params, x[:, -1:])[:, 0], caches, S

    def decode_step(self, params, token, caches, pos: int):
        """token: (B,1) int; pos: write index into caches (written in place)."""
        cfg = self.cfg
        x = self._embed(params, token)
        ctx = {}
        for g, gp, gc in zip(self.groups, params["groups"], caches):
            for i in range(g.n):
                x, _ = g.decode(layer(gp, i), x, layer(gc, i), pos, ctx)
        x = rmsnorm(x, params["norm_f"].to(x.dtype), cfg.norm_eps)
        return self._head(params, x)[:, 0], caches

    def init_caches(self, batch: int, seq: int, dtype=None):
        dtype = dtype or self.cfg.activation_dtype
        out = []
        for g in self.groups:
            one = g.init_cache(batch, seq, dtype, self.device)
            out.append(type(one)(*(torch.zeros((g.n,) + tuple(t.shape), dtype=t.dtype,
                                               device=t.device) for t in one)))
        return out

    # --------------------------------------------------------------- loss --

    def loss(self, params, batch):
        """batch: {tokens (B,S), targets (B,S), [patches]} -> scalar CE."""
        logits, aux = self.forward_train(params, batch["tokens"], batch)
        ce = softmax_xent(logits, batch["targets"])
        return ce + 0.01 * aux


def softmax_xent(logits, targets):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - gold)


class EncDecLM:
    """Whisper-style encoder-decoder: not ported yet."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        raise NotImplementedError(f"the encoder-decoder model of {cfg.name} {_NOT_PORTED}")


# ------------------------------------------------------------- factories ----

def build_model(cfg: ModelConfig, device="cuda"):
    if cfg.is_encdec:
        return EncDecLM(cfg, device)
    return LM(cfg, device)


def count_params_struct(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the shapes of ``init`` on the ``meta``
    device (nothing allocated)."""
    from repro_torch.distributed.sharding import param_paths

    params = build_model(cfg, device="meta").init()
    total = routed = 0
    for path, leaf in param_paths(params):
        n = leaf.numel()
        total += n
        if "experts" in path:
            routed += n
    if active_only and cfg.moe is not None:
        E, K = cfg.moe.n_experts, cfg.moe.top_k
        total = total - routed + routed * K // E
    return total
