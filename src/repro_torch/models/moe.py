"""Mixture-of-Experts FFN with a selectable dispatch implementation: the port
of ``repro.models.moe``.

The router's output is a sparse (slots x tokens) matrix P with T*K entries;
dispatch is X_e = P @ X and combine is Y = P^T @ (weights * H). The lanes
are the reference's:

  'onehot'  : dense masked einsum (O(T*E*C*D); smoke scale only).
  'sort'    : sort-by-expert + capacity gather/scatter.
  'coo'     : dispatch/combine as COO SpMM through ``SparseOperator`` (the
              ``coo_spmv`` kernel on ``cuda``, one SpMV per column of X).
  'bsr'     : the same products as BSR SpMM over 8x8 blocks laid out from
              the routing indices (the ``bsr_spmm`` kernel on ``cuda``).
  'grouped' : per-group routing (groups = data-parallel degree), which is
              'sort' when there is one group.

Every lane shares the router, the capacity and the slot assignment, and
builds its containers on the tokens' device from the routing tensors (no
host round trip), so the ambient policy (``use_backend(...)``) picks the
backend exactly as for any other product.

Routing matches the reference exactly: top-k breaks ties to the lower
expert (a stable descending sort), the slot assignment uses a stable
argsort and a left ``searchsorted``. The reference's ``.at[].set`` is
``index_put_``; its ``.at[].add`` combine is a fixed-order sum
(``combine_in_order``): each token's contributions, taken by a stable sort
by token in their sorted-by-expert order, fold left to right in f32 and
round once to the activation dtype, which is what ``index_add_`` computes
on the host (it adds a bf16 row in f32). No lane adds floats with atomics,
so every lane repeats its bits on the card.

On a ``DeviceMesh`` (tokens a DTensor under ``sharding_context``) the MoE
is expert-parallel, as the reference's rules say: the expert weights are
split along the expert dim over the ``experts`` axes (``model``), the
capacity over the ``expert_cap`` axes (``data``) where the local slot
count stays a whole number of 8-row blocks. The router runs on DTensors;
the lanes, whose sorts, gathers, container builds and kernel launches take
plain tensors, run in one ``local_map`` region (:func:`_moe_sharded`). Each
rank holds every token and the full routing, so the slot assignment is the
reference's, and computes only the slots of its own experts and capacity
chunk; the combine's result is partial over those axes and is reduced.
The sum over experts then runs in another order than on one device, so a
sharded run holds to a tolerance; where every such axis has size 1 the
bits are equal.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (axis_sizes, current_mesh, dtensor_mesh,
                                              logical_constraint, spec_for, split_dim)

from .layers import Init, dense_init

#: Block edge of the 'bsr' lane: ``_capacity`` rounds C (hence E*C) to it.
BSR_BLOCK = 8


def init_moe(init: Init, cfg, mcfg):
    D, E, Fd = cfg.d_model, mcfg.n_experts, mcfg.d_expert_ff
    scale = 1.0 / math.sqrt(D)
    p = {
        "router": init.normal((D, E), scale, torch.float32),
        "experts": {
            "w_gate": init.normal((E, D, Fd), scale),
            "w_up": init.normal((E, D, Fd), scale),
            "w_down": init.normal((E, Fd, D), 1.0 / math.sqrt(Fd)),
        },
    }
    if mcfg.n_shared:
        Fs = mcfg.d_shared_ff or mcfg.n_shared * Fd
        p["shared"] = {
            "w_gate": dense_init(init, D, Fs),
            "w_up": dense_init(init, D, Fs),
            "w_down": dense_init(init, Fs, D),
        }
    return p


def _capacity(T: int, K: int, E: int, factor: float) -> int:
    c = int(math.ceil(T * K / E * factor))
    return max(8, -(-c // 8) * 8)


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last dim, ties to the lower index (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_counts(tope, E: int) -> torch.Tensor:
    """Picks per expert, f32 (whole numbers, exact in any order of adds;
    ``bincount`` would read its size back from the device)."""
    idx = tope.reshape(-1)
    ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    return torch.zeros(E, dtype=torch.float32, device=idx.device).index_add_(0, idx, ones)


def combine_in_order(contrib, t_s, T: int, K: int) -> torch.Tensor:
    """``y[t] = 0 + c_0 + c_1 + ...`` over token ``t``'s ``K`` entries of
    ``contrib`` (rows in the sorted-by-expert entry order, ``t_s`` their
    tokens), folded left to right in f32 in ascending expert order and
    rounded once to ``contrib``'s dtype: ``index_add_``'s result on the
    host, bit for bit, with no atomics. Every token owns exactly ``K``
    entries (a dropped one adds ``+0``, which changes no sum)."""
    order = torch.argsort(t_s, stable=True)
    c = contrib[order].reshape(T, K, contrib.shape[-1])
    y = torch.zeros(c[:, 0].shape, dtype=torch.float32, device=c.device)
    for k in range(K):
        y = y + c[:, k].float()
    return y.to(contrib.dtype)


def _gates(p, x):
    # in f32 (a bf16 router, ZeRO's or beside a kept master, is widened
    # first, as the reference's type promotion does)
    return torch.softmax(x.float() @ p["router"].float(), dim=-1)   # (T, E)


def _top(gates, k: int):
    """The top-k gates renormalised, their experts, and the share of picks
    per expert."""
    topw, tope = top_k(gates, k)                             # (T, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    f = _expert_counts(tope, gates.shape[-1]) / tope.numel()
    return topw, tope, f


def _aux(gates, f):
    """Switch-style load-balancing loss."""
    return gates.shape[-1] * torch.sum(f * gates.mean(dim=0))


def _route(p, x, mcfg):
    """Common router: top-k gates renormalised, plus Switch-style aux loss."""
    gates = _gates(p, x)
    topw, tope, f = _top(gates, mcfg.top_k)
    return topw, tope, _aux(gates, f)


def _experts_ffn(p, xe):
    """xe: (E, C, D) -> (E, C, D), matmuls in the activation dtype."""
    w_gate = p["w_gate"].to(xe.dtype)
    w_up = p["w_up"].to(xe.dtype)
    w_down = p["w_down"].to(xe.dtype)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def moe_ffn(p, x, cfg, mcfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) flat tokens -> (y, aux_loss). Dispatch per mcfg.dispatch_impl."""
    impl = mcfg.dispatch_impl
    mesh = dtensor_mesh(x)
    if mesh is not None:
        y, aux = _moe_sharded(p, x, cfg, mcfg, mesh)
    elif impl == "grouped":
        y, aux = _moe_grouped(p, x, cfg, mcfg)
    else:
        y, aux = _moe_flat(p, x, mcfg)
    if "shared" in p:
        from .layers import apply_mlp
        y = y + apply_mlp(p["shared"], x)
    return logical_constraint(y, ("batch", None)), aux


def _moe_flat(p, x, mcfg):
    """One routing over every token, then the lane of ``mcfg.dispatch_impl``
    ('sort' for 'grouped' with one group)."""
    E, K = mcfg.n_experts, mcfg.top_k
    C = _capacity(x.shape[0], K, E, mcfg.capacity_factor)
    topw, tope, aux = _route(p, x, mcfg)
    return _lane(mcfg.dispatch_impl)(p["experts"], x, tope, topw, E, C), aux


# ----------------------------------------------------------- grouped path ----

def _num_groups(mcfg, T):
    """Groups = DP degree (pod x data) of the ambient mesh, else 1."""
    if getattr(mcfg, "n_groups", 0):
        return mcfg.n_groups
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    g = 1
    for ax in ("pod", "data"):
        if ax in sizes:
            g *= sizes[ax]
    return g if g > 1 and T % g == 0 else 1


def _moe_grouped(p, x, cfg, mcfg):
    """GShard-style per-group dispatch: routing, sort and scatter stay
    group-local; the reference's vmap over groups is a loop here."""
    T, D = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    G = _num_groups(mcfg, T)
    if G == 1:
        return _moe_flat(p, x, mcfg)
    Tg = T // G
    C = _capacity(Tg, K, E, mcfg.capacity_factor)
    dev = x.device

    x3 = logical_constraint(split_dim(x, 0, (G, Tg)), ("batch", None, None))
    logits = x3.float() @ p["router"].float()                # (G, Tg, E)
    gates = torch.softmax(logits, dim=-1)
    topw, tope = top_k(gates, K)                             # (G, Tg, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    f = _expert_counts(tope, E) / tope.numel()
    aux = E * torch.sum(f * gates.mean(dim=(0, 1)))

    ys = []
    for g in range(G):
        slot, t_s, w_s, keep = _dispatch_indices(tope[g], topw[g], Tg, E, K, C)
        # slot-space inverse map: the token each (expert, cap) slot feeds
        # (sentinel slot -> token Tg, a zero row)
        t_slot = torch.full((E * C + 1,), Tg, dtype=torch.long, device=dev)
        t_slot[slot] = t_s
        xpad = torch.cat([x3[g], torch.zeros((1, D), dtype=x.dtype, device=dev)])
        xe = xpad[t_slot[: E * C]].reshape(1, E, C, D)
        h = _experts_ffn_grouped(p["experts"], xe)[0]
        ys.append(_combine_entries(h, slot, t_s, w_s, keep, Tg, K))
    y3 = logical_constraint(torch.stack(ys), ("batch", None, None))
    return y3.reshape(T, D).to(x.dtype), aux


def _experts_ffn_grouped(p, xe):
    """xe: (G, E, C, D) -> (G, E, C, D); contraction is local per (g, e)."""
    w_gate = p["w_gate"].to(xe.dtype)
    w_up = p["w_up"].to(xe.dtype)
    w_down = p["w_down"].to(xe.dtype)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate)) * torch.einsum(
        "gecd,edf->gecf", xe, w_up)
    return torch.einsum("gecf,efd->gecd", h, w_down)


# ------------------------------------------------------------- sort path ----

class Part(NamedTuple):
    """The slots one rank computes: experts ``[e0, e0 + E)`` and capacity
    positions ``[c0, c0 + C)`` of each."""

    e0: int
    E: int
    c0: int
    C: int


def _dispatch_indices(tope, topw, T, E, K, C, part: Optional[Part] = None):
    """Shared routing -> slot assignment. Returns (slot, tok, w, keep) flat.
    With ``part`` only its slots are kept, numbered ``e * part.C + pos``
    from its first expert and position (``part.E * part.C`` for every
    other entry)."""
    dev = tope.device
    e_flat = tope.reshape(-1)                                # (T*K,)
    t_flat = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    w_flat = topw.reshape(-1)
    order = torch.argsort(e_flat, stable=True)               # group by expert
    e_s, t_s, w_s = e_flat[order], t_flat[order], w_flat[order]
    # position within the expert's segment = index - first occurrence of e_s
    pos = torch.arange(T * K, device=dev) - torch.searchsorted(e_s, e_s, side="left")
    keep = pos < C
    if part is not None:
        e_s, pos = e_s - part.e0, pos - part.c0
        keep &= (e_s >= 0) & (e_s < part.E) & (pos >= 0) & (pos < part.C)
        E, C = part.E, part.C
    slot = torch.where(keep, e_s * C + pos, torch.full((), E * C, device=dev))
    return slot, t_s, w_s, keep


def _sort_lane(experts, x, tope, topw, E, C, part=None):
    """The 'sort' lane's dispatch, expert FFN and combine of the slots of
    ``part`` (all of them by default)."""
    T, D = x.shape
    K = tope.shape[-1]
    slot, t_s, w_s, keep = _dispatch_indices(tope, topw, T, E, K, C, part)
    E, C = (part.E, part.C) if part is not None else (E, C)
    xe = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    xe[slot] = x[t_s]
    xe = xe[: E * C].reshape(E, C, D)
    xe = logical_constraint(xe, ("experts", "expert_cap", None))
    h = _experts_ffn(experts, xe)
    h = logical_constraint(h, ("experts", "expert_cap", None))
    return _combine_entries(h, slot, t_s, w_s, keep, T, K).to(x.dtype)


def _combine_entries(h, slot, t_s, w_s, keep, T, K):
    """The combine of 'sort' and 'grouped': each routed entry's expert row
    (the zero pad row for a dropped one) times its weight, summed per
    token in a fixed order (``combine_in_order``)."""
    E_C, D = h.shape[0] * h.shape[1], h.shape[-1]
    h_flat = torch.cat([h.reshape(E_C, D), torch.zeros((1, D), dtype=h.dtype, device=h.device)])
    w = torch.where(keep, w_s, torch.zeros((), device=h.device))
    return combine_in_order(h_flat[slot] * w[:, None].to(h.dtype), t_s, T, K)


# ----------------------------------------------------------- onehot path ----

def _onehot_lane(experts, x, tope, topw, E, C, part=None):
    """GShard-style dense dispatch (vendor path; O(T*E*C*D))."""
    T, D = x.shape
    K = tope.shape[-1]
    slot, t_s, w_s, keep = _dispatch_indices(tope, topw, T, E, K, C, part)
    E, C = (part.E, part.C) if part is not None else (E, C)
    dev = x.device
    disp = torch.zeros((T, E * C + 1), dtype=x.dtype, device=dev)
    disp[t_s, slot] = keep.to(x.dtype)
    comb = torch.zeros((T, E * C + 1), dtype=torch.float32, device=dev)
    comb[t_s, slot] = torch.where(keep, w_s, torch.zeros((), device=dev))
    xe = torch.einsum("ts,td->sd", disp[:, : E * C], x).reshape(E, C, D)
    h = _experts_ffn(experts, xe).reshape(E * C, D)
    y = torch.einsum("ts,sd->td", comb[:, : E * C].to(h.dtype), h)
    return y.to(x.dtype)


# -------------------------------------------------------------- coo path ----

def coo_dispatch(slot, t_s, keep, T, E, C, dtype):
    """P_disp (E*C, T): row ``slot`` (``E*C`` for a dropped entry, a
    sentinel past the last row) and column ``t_s`` of every routed entry,
    value 1 (0 when dropped). Its rows interleave the sentinels with the
    kept slots, in the reference's entry order, so the container is marked
    ``UNSORTED``: its products take the stable row sort without reading the
    order from the device."""
    from repro_torch.core.formats import COO

    return _unsorted(COO(slot.to(torch.int32), t_s.to(torch.int32), keep.to(dtype), (E * C, T)))


def coo_combine(slot, t_s, w_s, keep, T, E, C, dtype):
    """P_comb (T, E*C+1) = (P*w)^T: rows are tokens in expert order (not
    sorted, so the container is marked ``UNSORTED``), columns slots; a
    dropped entry weighs 0 against the pad column ``E*C``."""
    from repro_torch.core.formats import COO

    w = torch.where(keep, w_s, torch.zeros((), device=w_s.device)).to(dtype)
    return _unsorted(COO(t_s.to(torch.int32), slot.to(torch.int32), w, (T, E * C + 1)))


def _unsorted(P):
    """``P`` marked as a COO whose rows may go down: the kernels sort it
    without reading the device, so a captured decode step can hold it."""
    from repro_torch.kernels.coo_spmv import UNSORTED

    P.cache[UNSORTED] = True
    return P


def _coo_lane(experts, x, tope, topw, E, C, part=None):
    """Dispatch/combine as COO SpMM through ``SparseOperator``, so the
    ambient policy picks the kernel backend."""
    from repro_torch.core.operator import SparseOperator

    T, D = x.shape
    K = tope.shape[-1]
    slot, t_s, w_s, keep = _dispatch_indices(tope, topw, T, E, K, C, part)
    E, C = (part.E, part.C) if part is not None else (E, C)
    P_disp = coo_dispatch(slot, t_s, keep, T, E, C, x.dtype)
    xe = (SparseOperator(P_disp) @ x).reshape(E, C, D)
    h = _experts_ffn(experts, xe).reshape(E * C, D)
    P_comb = coo_combine(slot, t_s, w_s, keep, T, E, C, h.dtype)
    h_pad = torch.cat([h, torch.zeros((1, D), dtype=h.dtype, device=h.device)])
    y = SparseOperator(P_comb) @ h_pad
    return y.to(x.dtype)


# -------------------------------------------------------------- bsr path ----

def bsr_dispatch(slot, t_s, keep, T, E, C, dtype):
    """P_disp (E*C, T) as 8x8 blocks: slots are unique per kept entry, so
    lane ``slot % 8`` of block row ``slot // 8`` is collision-free; dropped
    entries land in an extra block row, cut off."""
    from repro_torch.core.formats import BSR

    bs = BSR_BLOCK
    dev = slot.device
    nbr = E * C // bs
    br, lane = slot // bs, slot % bs
    bcols = torch.full((nbr + 1, bs), -1, dtype=torch.int32, device=dev)
    bcols[br, lane] = (t_s // bs).to(torch.int32)
    blocks = torch.zeros((nbr + 1, bs, bs, bs), dtype=dtype, device=dev)
    blocks[br, lane, lane, t_s % bs] = keep.to(dtype)
    return BSR(bcols[:nbr], blocks[:nbr], (E * C, T))


def bsr_combine(slot, tope, w_s, keep, T, E, C, dtype):
    """P_comb (T, E*C+1) = (P*w)^T as 8x8 blocks. Slots and weights go back
    to the flat (token, k) layout, so token t's K entries own K distinct
    lanes of its block row; dropped entries keep weight 0 against the
    overflow column."""
    from repro_torch.core.formats import BSR

    bs = BSR_BLOCK
    dev = slot.device
    K = tope.shape[-1]
    order = torch.argsort(tope.reshape(-1), stable=True)
    slot_o = torch.zeros((T * K,), dtype=torch.long, device=dev)
    slot_o[order] = slot
    w_o = torch.zeros((T * K,), dtype=torch.float32, device=dev)
    w_o[order] = torch.where(keep, w_s, torch.zeros((), device=dev))
    i = torch.arange(T * K, device=dev)
    t, k = i // K, i % K
    j = (t % bs) * K + k
    nbr = -(-T // bs)
    bcols = torch.full((nbr, bs * K), -1, dtype=torch.int32, device=dev)
    bcols[t // bs, j] = (slot_o // bs).to(torch.int32)
    blocks = torch.zeros((nbr, bs * K, bs, bs), dtype=dtype, device=dev)
    blocks[t // bs, j, t % bs, slot_o % bs] = w_o.to(dtype)
    return BSR(bcols, blocks, (T, E * C + 1))


def _bsr_lane(experts, x, tope, topw, E, C, part=None):
    """Dispatch/combine as BSR SpMM through ``SparseOperator``: the same
    slot assignment as 'sort'/'coo', the containers laid out on the device
    from the routing indices."""
    from repro_torch.core.operator import SparseOperator

    T, D = x.shape
    K = tope.shape[-1]
    slot, t_s, w_s, keep = _dispatch_indices(tope, topw, T, E, K, C, part)
    E, C = (part.E, part.C) if part is not None else (E, C)
    P_disp = bsr_dispatch(slot, t_s, keep, T, E, C, x.dtype)
    xe = (SparseOperator(P_disp) @ x).reshape(E, C, D)
    h = _experts_ffn(experts, xe).reshape(E * C, D)
    P_comb = bsr_combine(slot, tope, w_s, keep, T, E, C, h.dtype)
    h_pad = torch.cat([h, torch.zeros((1, D), dtype=h.dtype, device=h.device)])
    y = SparseOperator(P_comb) @ h_pad
    return y.to(x.dtype)


# ------------------------------------------------------- on a device mesh ----

def _lane(impl: str):
    """The lane of a ``dispatch_impl`` ('sort' for 'grouped', run once a
    group, and for any other name)."""
    return {"onehot": _onehot_lane, "coo": _coo_lane, "bsr": _bsr_lane}.get(impl, _sort_lane)


def _entry_axes(spec, d: int) -> Tuple[str, ...]:
    e = spec[d] if d < len(spec) else None
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def _coord(mesh, axes) -> int:
    """This rank's chunk index along ``axes`` (major first)."""
    sizes, i = axis_sizes(mesh), 0
    for a in axes:
        i = i * sizes[a] + mesh.get_local_rank(a)
    return i


def _moe_sharded(p, x, cfg, mcfg, mesh):
    """The MoE on DTensors, expert-parallel (see the module docstring).

    The router and the aux loss run on DTensors. One ``local_map`` region
    takes the gates and the tokens whole (gathered over every axis) and the
    expert weights split along the expert dim over the ``experts`` axes,
    and gives this rank's part of the combine (its experts, its capacity
    chunk) as a partial sum over the ``experts`` and ``expert_cap`` axes,
    with the picks per expert for the aux loss. The gradients of the gates,
    the tokens and the weights come back partial over those axes too.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    T, D = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    impl = mcfg.dispatch_impl
    G = _num_groups(mcfg, T) if impl == "grouped" else 1
    C = _capacity(T // G, K, E, mcfg.capacity_factor)
    sizes = axis_sizes(mesh)
    spec = spec_for((E, C, D), ("experts", "expert_cap", None), mesh)
    e_axes, c_axes = _entry_axes(spec, 0), _entry_axes(spec, 1)
    El = E // math.prod(sizes[a] for a in e_axes)
    if (El * C // math.prod(sizes[a] for a in c_axes)) % BSR_BLOCK:
        c_axes = ()     # a capacity chunk is a whole number of 8-row blocks
    Cl = C // math.prod(sizes[a] for a in c_axes)
    names = mesh.mesh_dim_names
    split = set(e_axes) | set(c_axes)
    whole = tuple(Replicate() for _ in names)
    part_sum = tuple(Partial() if n in split else Replicate() for n in names)
    w_in = tuple(Shard(0) if n in e_axes else Replicate() for n in names)
    w_grad = tuple(Shard(0) if n in e_axes else Partial() if n in c_axes else Replicate()
                   for n in names)

    def region(gates, x, w_gate, w_up, w_down):
        part = Part(_coord(mesh, e_axes) * El, El, _coord(mesh, c_axes) * Cl, Cl)
        topw, tope, f = _top(gates, K)
        lane, experts = _lane(impl), {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        if G == 1:
            return lane(experts, x, tope, topw, E, C, part), f
        Tg = T // G
        ys = [lane(experts, x[g * Tg:(g + 1) * Tg], tope[g * Tg:(g + 1) * Tg],
                   topw[g * Tg:(g + 1) * Tg], E, C, part) for g in range(G)]
        return torch.cat(ys), f

    gates = _gates(p, x)
    ex = p["experts"]
    y, f = local_map(region, out_placements=(part_sum, whole),
                     in_placements=(whole, whole, w_in, w_in, w_in),
                     in_grad_placements=(part_sum, part_sum, w_grad, w_grad, w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        gates, x, ex["w_gate"], ex["w_up"], ex["w_down"])
    return y, _aux(gates, f)
