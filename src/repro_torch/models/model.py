"""Model assembly: config -> (init, train loss, prefill, decode) for every
family: the port of ``repro.models.model``.

Layer stacks are kept as the reference keeps them: each group's parameters
are stacked along a leading layer axis (``params["groups"][g]``, every leaf
``(n, ...)``), and caches are stacked the same way. The reference scans over
that axis; here a Python loop walks it, one layer at a time, and the decode
step writes each layer's cache slice in place (the reference donates the
caches to the step): attention and MLA write their slot at ``pos``, and the
state a Mamba or RWKV layer returns is copied into its slice. ``pos`` is an
int or, as the reference traces it, a 0-dim integer tensor on the device,
so one captured step serves every position
(``repro_torch.serve.CapturedDecode``).

  dense/vlm       : [attn+mlp] x L
  moe (qwen3)     : [attn+moe] x L
  moe (deepseek)  : [mla+mlp] x first_dense + [mla+moe] x rest
  hybrid (jamba)  : [(mamba|attn)+(mlp|moe) period of `attn_period`] x L/period
  ssm (rwkv6)     : [rwkv] x L
  audio (whisper) : encoder [attn+mlp] x Le ; decoder [self+cross+mlp] x Ld
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import resolve_device
from repro_torch.distributed.sharding import logical_constraint, merge_dims, split_dim
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import rebuild, tree_map

from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .layers import Init, apply_mlp, dense_init, embed_init, embed_lookup, init_mlp, rmsnorm


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
        B, S = x.shape[:2]
        y, aux = moe_mod.moe_ffn(lp_ffn, merge_dims(x, 0), cfg, cfg.moe)
        return split_dim(y, 0, (B, S)), aux
    return apply_mlp(lp_ffn, x), torch.zeros((), dtype=torch.float32, device=x.device)


def attn_block(cfg: ModelConfig, use_moe: bool, use_mla: bool, name: str) -> GroupDef:
    def init(ini: Init):
        return {
            "ln1": ini.ones((cfg.d_model,)),
            "mixer": mla_mod.init_mla(ini, cfg) if use_mla else attn.init_attention(ini, cfg),
            "ln2": ini.ones((cfg.d_model,)),
            "ffn": _ffn_init(ini, cfg, use_moe),
        }

    def train(lp, x, ctx):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        if use_mla:
            h = mla_mod.mla_train(lp["mixer"], h, cfg, ctx["positions"])
        else:
            h = attn.attention_train(lp["mixer"], h, cfg, ctx["positions"])
        x = x + h
        seq_ax = "seq_act" if cfg.seq_parallel else None
        x = logical_constraint(x, ("batch", seq_ax, None))
        f = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y, aux = _ffn_apply(lp["ffn"], f, cfg, use_moe)
        return x + y, aux

    def prefill(lp, x, ctx):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        if use_mla:
            h, cache = mla_mod.mla_prefill(lp["mixer"], h, cfg, ctx["positions"])
        else:
            h, cache = attn.attention_prefill(lp["mixer"], h, cfg, ctx["positions"])
        x = x + h
        f = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y, aux = _ffn_apply(lp["ffn"], f, cfg, use_moe)
        return x + y, cache, aux

    def decode(lp, x, cache, pos, ctx):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        if use_mla:
            h, cache = mla_mod.mla_decode(lp["mixer"], h, cfg, cache, pos)
        else:
            h, cache = attn.attention_decode(lp["mixer"], h, cfg, cache, pos)
        x = x + h
        f = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y, _ = _ffn_apply(lp["ffn"], f, cfg, use_moe)
        return x + y, cache

    def init_cache(batch, seq, dtype, device):
        if use_mla:
            return mla_mod.init_mla_cache(cfg, batch, seq, dtype, device)
        shape = (batch, seq, cfg.n_kv_heads, cfg.hd)
        return attn.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                            torch.zeros(shape, dtype=dtype, device=device))

    return GroupDef(name, 0, init, train, prefill, decode, init_cache)


def mamba_block(cfg: ModelConfig, use_moe: bool, name: str) -> GroupDef:
    def init(ini: Init):
        return {
            "ln1": ini.ones((cfg.d_model,)),
            "mixer": ssm_mod.init_mamba(ini, cfg),
            "ln2": ini.ones((cfg.d_model,)),
            "ffn": _ffn_init(ini, cfg, use_moe),
        }

    def _body(lp, x, state):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        h, new_state = ssm_mod.mamba_forward(lp["mixer"], h, cfg, state)
        x = x + h
        f = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y, aux = _ffn_apply(lp["ffn"], f, cfg, use_moe)
        return x + y, new_state, aux

    def train(lp, x, ctx):
        x, _, aux = _body(lp, x, None)
        return x, aux

    def prefill(lp, x, ctx):
        return _body(lp, x, None)

    def decode(lp, x, state, pos, ctx):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        h, new_state = ssm_mod.mamba_decode(lp["mixer"], h, cfg, state)
        x = x + h
        f = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y, _ = _ffn_apply(lp["ffn"], f, cfg, use_moe)
        return x + y, new_state

    def init_cache(batch, seq, dtype, device):
        return ssm_mod.init_mamba_state(cfg, batch, dtype, device)

    return GroupDef(name, 0, init, train, prefill, decode, init_cache)


def rwkv_block(cfg: ModelConfig, name: str) -> GroupDef:
    def init(ini: Init):
        return {
            "ln1": ini.ones((cfg.d_model,)),
            "ln2": ini.ones((cfg.d_model,)),
            "mix": rwkv_mod.init_rwkv(ini, cfg),
        }

    def _full(lp, x, state):
        h = rmsnorm(x, lp["ln1"].to(x.dtype), cfg.norm_eps)
        y, tm_shift, wkv = rwkv_mod.rwkv_time_mix(lp["mix"], h, cfg, state)
        x = x + y
        h2 = rmsnorm(x, lp["ln2"].to(x.dtype), cfg.norm_eps)
        y2, cm_shift = rwkv_mod.rwkv_channel_mix(lp["mix"], h2, cfg, state)
        x = x + y2
        return x, rwkv_mod.RWKVState(tm_shift.to(x.dtype), cm_shift.to(x.dtype), wkv)

    def train(lp, x, ctx):
        x, _ = _full(lp, x, None)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def prefill(lp, x, ctx):
        x, st = _full(lp, x, None)
        return x, st, torch.zeros((), dtype=torch.float32, device=x.device)

    def decode(lp, x, state, pos, ctx):
        return _full(lp, x, state)

    def init_cache(batch, seq, dtype, device):
        return rwkv_mod.init_rwkv_state(cfg, batch, dtype, device)

    return GroupDef(name, 0, init, train, prefill, decode, init_cache)


def jamba_period(cfg: ModelConfig, name: str) -> GroupDef:
    """One period of `attn_period` layers: attention at slot period//2,
    mamba elsewhere; MoE FFN on every `moe_every`-th slot."""
    period = cfg.attn_period
    attn_slot = period // 2
    subs: List[GroupDef] = []
    for i in range(period):
        use_moe = cfg.moe is not None and (i % cfg.moe_every == cfg.moe_every - 1)
        if i == attn_slot:
            subs.append(attn_block(cfg, use_moe, False, f"sub{i}_attn"))
        else:
            subs.append(mamba_block(cfg, use_moe, f"sub{i}_mamba"))

    def init(ini: Init):
        return {f"sub{i}": subs[i].init(ini) for i in range(period)}

    def train(lp, x, ctx):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(period):
            x, a = subs[i].train(lp[f"sub{i}"], x, ctx)
            aux = aux + a
        return x, aux

    def prefill(lp, x, ctx):
        caches, aux = {}, torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(period):
            x, c, a = subs[i].prefill(lp[f"sub{i}"], x, ctx)
            caches[f"sub{i}"] = c
            aux = aux + a
        return x, caches, aux

    def decode(lp, x, cache, pos, ctx):
        new = {}
        for i in range(period):
            x, c = subs[i].decode(lp[f"sub{i}"], x, cache[f"sub{i}"], pos, ctx)
            new[f"sub{i}"] = c
        return x, new

    def init_cache(batch, seq, dtype, device):
        return {f"sub{i}": subs[i].init_cache(batch, seq, dtype, device)
                for i in range(period)}

    return GroupDef(name, 0, init, train, prefill, decode, init_cache)


# -------------------------------------------------------------- assembly ----

def build_groups(cfg: ModelConfig) -> List[GroupDef]:
    if cfg.rwkv:
        return [rwkv_block(cfg, "rwkv")._replace(n=cfg.n_layers)]
    if cfg.attn_period:  # jamba
        if cfg.n_layers % cfg.attn_period:
            raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a multiple of "
                             f"attn_period={cfg.attn_period}")
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


def _stack_init(draw: Callable, n: int, init: Init, local: Callable = None):
    """``n`` layers drawn one after another by ``draw(init)``, each leaf
    stacked along a leading layer axis. Each layer is copied into a stack
    allocated from the first one's leaves, so no more than one layer lives
    beside the stack (one layer is a view of itself, with no copy). With
    ``local`` (a drawn layer -> the tree of its local shards) only each
    layer's shard is kept, at once."""
    local = local or (lambda tree: tree)
    first = local(draw(init))
    if n == 1:
        return tree_map(lambda t: t[None], first)
    stack = tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                           device=t.device), first)
    write_back(layer(stack, 0), first)
    del first
    for i in range(1, n):
        write_back(layer(stack, i), local(draw(init)))
    return stack


class _Placer:
    """Where ``init`` puts each leaf: as drawn (no mesh), or, on a
    ``DeviceMesh``, as a DTensor of the leaf's placements in ``shardings``
    (``{path: placements}``, :func:`params_shardings`) holding only this
    rank's chunk. Every rank draws every leaf from the same stream, so the
    sharded params are the unsharded ones, and nothing is sent; a stacked
    group keeps each layer's chunk as soon as the layer is drawn, so no
    rank holds more than one whole layer beside its shards."""

    def __init__(self, mesh=None, shardings=None):
        self.mesh, self.shardings = mesh, shardings

    def leaf(self, key: str, t):
        if self.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, self.shardings[key], src_data_rank=None)

    def stack(self, key: str, draw: Callable, n: int, init: Init):
        if self.mesh is None:
            return _stack_init(draw, n, init)
        from torch.distributed.tensor import DTensor, distribute_tensor

        from repro_torch.tree import map_with_path

        mesh, sh, shapes = self.mesh, self.shardings, {}

        def local(tree):
            def one(k, t):
                shapes[k] = (n,) + tuple(t.shape)
                # the layer as a stack of one: the stacked leaf's placements
                return distribute_tensor(t[None], mesh, sh[f"{key}/{k}"],
                                         src_data_rank=None).to_local()[0]
            return map_with_path(one, tree)

        stack = _stack_init(draw, n, init, local)
        return map_with_path(lambda k, t: DTensor.from_local(
            t, mesh, sh[f"{key}/{k}"], run_check=False, shape=torch.Size(shapes[k]),
            stride=torch.empty(shapes[k], device="meta").stride()), stack)


def _initializer(device, generator, weight_dtype) -> Init:
    """An :class:`Init` on ``device`` from a ``torch.Generator`` or a seed
    (no generator on the ``meta`` device)."""
    meta = torch.device(device).type == "meta"
    if isinstance(generator, int) and not meta:
        generator = torch.Generator(device=device).manual_seed(generator)
    return Init(generator if isinstance(generator, torch.Generator) else None, device,
                weight_dtype)


def _stack(trees):
    """Trees of one structure stacked leaf by leaf along a new first axis."""
    leaves = [tree_leaves(t) for t in trees]
    return rebuild(trees[0], [torch.stack(ls) for ls in zip(*leaves)])


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def reset_caches(caches) -> None:
    """Zero every leaf of ``caches`` in place (the state ``init_caches``
    gives), so the same buffers serve a new batch of requests: a captured
    decode step keeps their addresses."""
    for t in tree_leaves(caches):
        t.zero_()


def write_back(dst, src) -> None:
    """Copy a layer's returned cache ``src`` into its slice ``dst`` in place,
    leaf by leaf (a leaf the step already wrote in place is skipped)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def _dots_saveable(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of matrix products without a
    batch dimension (``mm``, ``addmm``), as the reference's
    ``dots_with_no_batch_dims_saveable``, and recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg):
    """A layer's train body under ``cfg.remat``, as the reference wraps it
    in ``jax.checkpoint``: ``"full"`` keeps the layer's inputs and
    recomputes the rest in backward (``torch.utils.checkpoint``, not
    reentrant); ``"dots"`` also keeps the products ``_dots_saveable``
    names. The recomputed forward runs the same routing and the same
    kernels, so backward sees the first pass's bits: it re-enters the
    forward's ambient policy and sharding context, which are per thread
    (on a CUDA device autograd recomputes on its own thread), and it runs
    to the end of the layer (PyTorch's early stop would end it by raising
    from inside the MoE lane's sparse product, where dispatch catches a
    failing kernel). Outside grad mode (serving, evaluation) the body runs
    as it is."""
    if cfg.remat not in ("full", "dots"):
        return fn
    import functools

    from torch.utils.checkpoint import (checkpoint, create_selective_checkpoint_contexts,
                                        set_checkpoint_early_stop)

    from repro_torch.core.operator import current_policy, use_policy
    from repro_torch.distributed.sharding import current_mesh, current_rules, sharding_context

    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_saveable)

    def body(lp, x, ctx):
        if not torch.is_grad_enabled():
            return fn(lp, x, ctx)
        policy, mesh, rules = current_policy(), current_mesh(), current_rules()

        def run(lp, x, ctx):
            with use_policy(policy), sharding_context(mesh, rules):
                return fn(lp, x, ctx)

        with set_checkpoint_early_stop(False):
            return checkpoint(run, lp, x, ctx, use_reentrant=False, preserve_rng_state=False,
                              **kw)

    return body


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

    def init(self, generator=0, weight_dtype: torch.dtype = torch.float32, mesh=None,
             shardings=None) -> Dict[str, Any]:
        """Parameters drawn from ``generator`` (a ``torch.Generator`` on the
        model's device, or a seed for one). ``weight_dtype`` is f32, the
        reference's; a server may keep every weight but the router in the
        activation dtype instead, the values the reference's per-use casts
        give, at half the bytes. On a ``DeviceMesh`` every leaf is a
        DTensor of its placements in ``shardings`` (``{path: placements}``,
        default ``params_shardings`` under the ambient rules) holding this
        rank's chunk of the same values (:class:`_Placer`)."""
        cfg = self.cfg
        ini = _initializer(self.device, generator, weight_dtype)
        put = _Placer(mesh, _shardings(self, mesh, shardings, weight_dtype))
        params: Dict[str, Any] = {
            "embed": put.leaf("embed", embed_init(ini, cfg.vocab, cfg.d_model)),
            "norm_f": put.leaf("norm_f", ini.ones((cfg.d_model,))),
            "groups": [put.stack(f"groups/{i}", g.init, g.n, ini)
                       for i, g in enumerate(self.groups)],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = put.leaf("lm_head",
                                         dense_init(ini, cfg.d_model, cfg.vocab, scale=0.02))
        if cfg.frontend == "vision":
            params["frontend_proj"] = put.leaf("frontend_proj",
                                               dense_init(ini, cfg.d_model, cfg.d_model))
        return params

    # ----------------------------------------------------------- helpers --

    def _embed(self, params, tokens):
        x = embed_lookup(params["embed"], tokens.long()).to(self.cfg.activation_dtype)
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
            body = _maybe_remat(g.train, cfg)
            for i in range(g.n):
                x, aux = body(layer(gp, i), x, ctx)
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
            caches.append(_stack(per_layer))
        x = rmsnorm(x, params["norm_f"].to(x.dtype), cfg.norm_eps)
        return self._head(params, x[:, -1:])[:, 0], caches, S

    def decode_step(self, params, token, caches, pos):
        """token: (B,1) int; pos: write index into caches, an int or a 0-dim
        integer tensor on the model's device. The caches are updated in
        place: each layer's returned cache is written back into its slice,
        so the next step sees this one's state."""
        cfg = self.cfg
        x = self._embed(params, token)
        ctx = {}
        for g, gp, gc in zip(self.groups, params["groups"], caches):
            for i in range(g.n):
                ci = layer(gc, i)
                x, new = g.decode(layer(gp, i), x, ci, pos, ctx)
                write_back(ci, new)
        x = rmsnorm(x, params["norm_f"].to(x.dtype), cfg.norm_eps)
        return self._head(params, x)[:, 0], caches

    def init_caches(self, batch: int, seq: int, dtype=None):
        dtype = dtype or self.cfg.activation_dtype
        out = []
        for g in self.groups:
            one = g.init_cache(batch, seq, dtype, self.device)
            out.append(tree_map(lambda t, n=g.n: torch.zeros(
                (n,) + tuple(t.shape), dtype=t.dtype, device=t.device), one))
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
    gold = _gold_logits(lf, targets[..., None].long())
    return torch.mean(lse[..., None] - gold)


def _gold_logits(lf, idx):
    """``gather(lf, -1, idx)``. Where ``lf`` is a DTensor whose vocab (its
    last dim) is split over mesh dims of size > 1, the gather is
    vocab-parallel in a ``local_map`` region, as :func:`layers.embed_lookup`
    is: each rank takes its own columns at the ids inside them (zeros
    elsewhere), a partial sum over the vocab's dims. DTensor's own gather
    there masks its input with a host-made scalar (``t[mask] = 0``), which a
    CUDA graph cannot record."""
    from repro_torch.distributed.sharding import dtensor_mesh, is_shard

    mesh = dtensor_mesh(lf)
    last = lf.ndim - 1
    vocab = [] if mesh is None else [
        i for i, p in enumerate(lf.placements)
        if is_shard(p) and p.dim % lf.ndim == last and mesh.size(i) > 1]
    if not vocab:
        return torch.gather(lf, -1, idx)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    lf_in = list(lf.placements)
    i_in = [p if is_shard(p) and p.dim % lf.ndim != last else Replicate() for p in lf_in]
    out = [Partial() if i in vocab else p for i, p in enumerate(i_in)]
    sizes = mesh.shape

    def gather(cols, ids):
        first = 0
        for i in vocab:
            first = first * sizes[i] + mesh.get_local_rank(i)
        ids = ids - first * cols.shape[-1]
        inside = (ids >= 0) & (ids < cols.shape[-1])
        got = torch.gather(cols, -1, torch.where(inside, ids, torch.zeros_like(ids)))
        return got * inside.to(got.dtype)

    return local_map(gather, out_placements=out, in_placements=(lf_in, i_in),
                     in_grad_placements=(lf_in, i_in), device_mesh=mesh,
                     redistribute_inputs=True)(lf, idx)


class DecCache(NamedTuple):
    self_kv: attn.KVCache
    cross_kv: attn.KVCache


@dataclass
class EncDecLM:
    """Whisper-style encoder-decoder on ``device``; the audio frontend is a
    stub (pre-embedded frames). Decoder = causal self-attn + cross-attn +
    MLP."""

    cfg: ModelConfig
    device: Any = "cuda"

    def __post_init__(self):
        if torch.device(self.device).type != "meta":
            self.device = resolve_device(self.device)

    def init(self, generator=0, weight_dtype: torch.dtype = torch.float32, mesh=None,
             shardings=None) -> Dict[str, Any]:
        """Parameters drawn from ``generator``, placed on ``mesh`` (as
        ``LM.init``)."""
        cfg = self.cfg
        ini = _initializer(self.device, generator, weight_dtype)
        put = _Placer(mesh, _shardings(self, mesh, shardings, weight_dtype))

        def enc_layer(i: Init):
            return {
                "ln1": i.ones((cfg.d_model,)),
                "attn": attn.init_attention(i, cfg),
                "ln2": i.ones((cfg.d_model,)),
                "mlp": init_mlp(i, cfg.d_model, cfg.d_ff),
            }

        def dec_layer(i: Init):
            return {
                "ln1": i.ones((cfg.d_model,)),
                "self": attn.init_attention(i, cfg),
                "ln2": i.ones((cfg.d_model,)),
                "cross": attn.init_cross_attention(i, cfg),
                "ln3": i.ones((cfg.d_model,)),
                "mlp": init_mlp(i, cfg.d_model, cfg.d_ff),
            }

        return {
            "embed": put.leaf("embed", embed_init(ini, cfg.vocab, cfg.d_model)),
            "enc": put.stack("enc", enc_layer, cfg.encoder_layers, ini),
            "dec": put.stack("dec", dec_layer, cfg.n_layers, ini),
            "norm_enc": put.leaf("norm_enc", ini.ones((cfg.d_model,))),
            "norm_f": put.leaf("norm_f", ini.ones((cfg.d_model,))),
            "lm_head": put.leaf("lm_head", dense_init(ini, cfg.d_model, cfg.vocab, scale=0.02)),
        }

    def _embed(self, params, tokens):
        return embed_lookup(params["embed"], tokens.long()).to(self.cfg.activation_dtype)

    def _positions(self, B: int, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device)[None].expand(B, S)

    def _norm(self, x, w):
        return rmsnorm(x, w.to(x.dtype), self.cfg.norm_eps)

    def encode(self, params, frames):
        cfg = self.cfg
        x = frames.to(cfg.activation_dtype)
        pos = self._positions(*x.shape[:2])

        def body(lp, x, ctx):
            h = attn.attention_train(lp["attn"], self._norm(x, lp["ln1"]), cfg, pos, causal=False)
            x = x + h
            return x + apply_mlp(lp["mlp"], self._norm(x, lp["ln2"]))

        body = _maybe_remat(body, cfg)
        for i in range(cfg.encoder_layers):
            x = body(layer(params["enc"], i), x, None)
        return self._norm(x, params["norm_enc"])

    def forward_train(self, params, tokens, extra):
        cfg = self.cfg
        enc = self.encode(params, extra["frames"])
        x = self._embed(params, tokens)
        pos = self._positions(*x.shape[:2])

        def body(lp, x, ctx):
            x = x + attn.attention_train(lp["self"], self._norm(x, lp["ln1"]), cfg, pos)
            x = x + attn.cross_attention(lp["cross"], self._norm(x, lp["ln2"]), enc, cfg)
            return x + apply_mlp(lp["mlp"], self._norm(x, lp["ln3"]))

        body = _maybe_remat(body, cfg)
        for i in range(cfg.n_layers):
            x = body(layer(params["dec"], i), x, None)
        x = self._norm(x, params["norm_f"])
        return (x @ params["lm_head"].to(x.dtype),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params, batch):
        logits, _ = self.forward_train(params, batch["tokens"], batch)
        return softmax_xent(logits, batch["targets"])

    def prefill(self, params, tokens, extra):
        """-> (last-position logits (B,V), caches with the cross K/V of the
        encoded frames, next_pos)."""
        cfg = self.cfg
        enc = self.encode(params, extra["frames"])
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        pos = self._positions(B, S)
        per_layer = []
        for i in range(cfg.n_layers):
            lp = layer(params["dec"], i)
            h, self_kv = attn.attention_prefill(lp["self"], self._norm(x, lp["ln1"]), cfg, pos)
            x = x + h
            ck = split_dim(enc @ lp["cross"]["wk"].to(x.dtype), 2, (cfg.n_kv_heads, cfg.hd))
            cv = split_dim(enc @ lp["cross"]["wv"].to(x.dtype), 2, (cfg.n_kv_heads, cfg.hd))
            x = x + attn.cross_attention(lp["cross"], self._norm(x, lp["ln2"]), enc, cfg)
            x = x + apply_mlp(lp["mlp"], self._norm(x, lp["ln3"]))
            per_layer.append(DecCache(self_kv, attn.KVCache(ck, cv)))
        x = self._norm(x, params["norm_f"])
        return x[:, -1] @ params["lm_head"].to(x.dtype), _stack(per_layer), S

    def decode_step(self, params, token, caches, pos):
        """token: (B,1) int; pos: write index into the self-attention caches
        (written in place), an int or a 0-dim integer tensor on the model's
        device; the cross caches are read only."""
        cfg = self.cfg
        x = self._embed(params, token)
        for i in range(cfg.n_layers):
            lp, cache = layer(params["dec"], i), layer(caches, i)
            h, _ = attn.attention_decode(lp["self"], self._norm(x, lp["ln1"]), cfg,
                                         cache.self_kv, pos)
            x = x + h
            x = x + attn.cross_attention_cached(lp["cross"], self._norm(x, lp["ln2"]),
                                                cache.cross_kv, cfg)
            x = x + apply_mlp(lp["mlp"], self._norm(x, lp["ln3"]))
        x = self._norm(x, params["norm_f"])
        return x[:, 0] @ params["lm_head"].to(x.dtype), caches

    def init_caches(self, batch: int, seq: int, dtype=None, enc_len: int = 1500):
        cfg = self.cfg
        dtype = dtype or cfg.activation_dtype

        def kv(s):
            shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.hd)
            return attn.KVCache(torch.zeros(shape, dtype=dtype, device=self.device),
                                torch.zeros(shape, dtype=dtype, device=self.device))

        return DecCache(kv(seq), kv(enc_len))


def cache_positions(caches):
    """The positions ``caches`` hold for the decode step (``Smax`` of their
    self-attention or MLA caches), or ``None`` where the model keeps no
    per-position cache (RWKV-6's state only)."""
    if isinstance(caches, DecCache):
        return caches.self_kv.k.shape[2]

    def find(tree):
        if isinstance(tree, attn.KVCache):
            return tree.k.shape[2]
        if isinstance(tree, mla_mod.MLACache):
            return tree.c_kv.shape[2]
        subtrees = tree.values() if isinstance(tree, dict) else tree
        if isinstance(tree, (dict, list, tuple)):
            for t in subtrees:
                n = find(t)
                if n is not None:
                    return n
        return None

    return find(caches)


def _shardings(model, mesh, shardings, weight_dtype):
    """``shardings``, or on a mesh the ambient rules' placements of the
    model's leaves (their shapes from an init on ``meta``)."""
    if mesh is None or shardings is not None:
        return shardings
    from repro_torch.distributed.sharding import params_shardings

    meta = type(model)(model.cfg, device="meta").init(weight_dtype=weight_dtype)
    return params_shardings(meta, mesh)


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
