"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the same numpy inputs and weights.

Routing is exact: the top-k experts, and the slots, tokens, weights and
kept entries the slot assignment gives for the same top-k (the top-k
weights themselves within ``rtol=1e-6``: each framework's matmul and
softmax round the gates). Every lane's output holds to the reference's
same lane and to the port's 'sort' at the reference's own MoE contract
(``tests/test_moe.py``): f32 ``rtol=1e-4, atol=1e-5``, aux ``rtol=1e-5``.
The dispatch matrices give X's rows back bit for bit.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import use_backend as juse_backend
from repro.core.formats import COO as JCOO
from repro.core.operator import SparseOperator as JOp
from repro.models import moe as jmoe

from repro_torch.core import SparseOperator, use_backend
from repro_torch.models import moe as tmoe

tcfg_base = importlib.import_module("repro_torch.configs.base")
jcfg_base = importlib.import_module("repro.configs.base")

F32 = dict(rtol=1e-4, atol=1e-5)


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


MOE_CFG = jcfg_base.ModelConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                                n_kv_heads=4, d_ff=64, vocab=64,
                                moe=jcfg_base.MoECfg(n_experts=8, top_k=2, d_expert_ff=48),
                                remat="none")
T_MOE_CFG = tcfg_base.ModelConfig(**{f.name: getattr(MOE_CFG, f.name)
                                     for f in dataclasses.fields(MOE_CFG) if f.name != "moe"},
                                  moe=tcfg_base.MoECfg(n_experts=8, top_k=2, d_expert_ff=48))


def _moe_setup(T, seed=0, **moe_kw):
    jm = dataclasses.replace(MOE_CFG.moe, **moe_kw)
    tm = dataclasses.replace(T_MOE_CFG.moe, **moe_kw)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), MOE_CFG, jm)
    x = np.random.default_rng(seed + 1).standard_normal((T, MOE_CFG.d_model)).astype(np.float32)
    tp = jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), p)
    return p, tp, x, jm, tm


#: (T, capacity_factor): no drops at 4.0; drops at 0.5 (C = 8 slots for 16
#: picks an expert on average at T = 64); decode's T = 4 (fewer tokens than
#: the block edge).
MOE_CASES = [(96, 4.0), (64, 0.5), (4, 1.25)]


@pytest.mark.parametrize("T,cf", MOE_CASES)
def test_routing_exact(T, cf):
    p, tp, x, jm, tm = _moe_setup(T, capacity_factor=cf)
    topw, tope, aux = jmoe._route(p, jnp.asarray(x), jm)
    ttopw, ttope, taux = tmoe._route(tp, _t(x), tm)
    assert np.array_equal(ttope.numpy(), np.asarray(tope))
    # the gates come from each framework's matmul and softmax: a few ulps
    np.testing.assert_allclose(ttopw.numpy(), np.asarray(topw), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)
    E, K = jm.n_experts, jm.top_k
    C = jmoe._capacity(T, K, E, cf)
    assert tmoe._capacity(T, K, E, cf) == C
    want = jmoe._dispatch_indices(tope, topw, T, E, K, C)
    got = tmoe._dispatch_indices(_t(np.asarray(tope)), _t(np.asarray(topw)), T, E, K, C)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    drops = int((~np.asarray(want[3])).sum())
    assert (drops > 0) == (cf < 1.0), drops


def test_top_k_ties_go_to_the_lower_index():
    gates = np.array([[0.25, 0.25, 0.1, 0.25, 0.15]], np.float32)
    want_w, want_e = jax.lax.top_k(jnp.asarray(gates), 3)
    got_w, got_e = tmoe.top_k(_t(gates), 3)
    assert got_e.tolist() == np.asarray(want_e).tolist() == [[0, 1, 3]]
    assert np.array_equal(got_w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("impl", ["sort", "onehot", "coo", "bsr", "grouped"])
@pytest.mark.parametrize("T,cf", MOE_CASES)
def test_moe_lanes_match_reference(impl, T, cf):
    """Every lane against the reference's same lane (its products on plain)
    and against its own 'sort', f32, with and without capacity drops, on
    the port's plain and cuda backends (on host tensors the kernels' plain
    versions run); the grouped lane over two groups."""
    groups = 2 if impl == "grouped" else 0
    p, tp, x, jm, tm = _moe_setup(T, capacity_factor=cf, dispatch_impl=impl, n_groups=groups)
    with juse_backend("plain"):
        want, aux = jmoe.moe_ffn(p, jnp.asarray(x), MOE_CFG, jm)
    for backend in ("plain", "cuda"):
        with use_backend(backend):
            got, taux = tmoe.moe_ffn(tp, _t(x), T_MOE_CFG, tm)
            sort, _ = tmoe.moe_ffn(tp, _t(x), T_MOE_CFG,
                                   dataclasses.replace(tm, dispatch_impl="sort"))
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)
        np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)
        if impl != "grouped":
            np.testing.assert_allclose(got.numpy(), sort.numpy(), **F32)


@pytest.mark.parametrize("T,cf", MOE_CASES)
def test_moe_dispatch_containers_give_the_dispatched_rows_exactly(T, cf):
    """The coo and bsr lanes' dispatch matrices give X's rows back bit for
    bit (the sort lane's xe) on both backends; both combine matrices (the
    coo one with rows not sorted) give the reference's combine product on
    the same routing."""
    p, tp, x, jm, tm = _moe_setup(T, capacity_factor=cf)
    E, K = jm.n_experts, jm.top_k
    C = jmoe._capacity(T, K, E, cf)
    topw, tope, _ = tmoe._route(tp, _t(x), tm)
    slot, t_s, w_s, keep = tmoe._dispatch_indices(tope, topw, T, E, K, C)
    xe = torch.zeros((E * C + 1, x.shape[1]))
    xe[slot] = _t(x)[t_s]
    for make in (tmoe.coo_dispatch, tmoe.bsr_dispatch):
        P = make(slot, t_s, keep, T, E, C, torch.float32)
        for backend in ("plain", "cuda"):
            with use_backend(backend):
                assert torch.equal(SparseOperator(P) @ _t(x), xe[: E * C])
    comb = tmoe.coo_combine(slot, t_s, w_s, keep, T, E, C, torch.float32)
    assert bool((comb.row[1:] < comb.row[:-1]).any())
    jtopw, jtope, _ = jmoe._route(p, jnp.asarray(x), jm)
    jslot, jt_s, jw_s, jkeep = jmoe._dispatch_indices(jtope, jtopw, T, E, K, C)
    h = np.random.default_rng(5).standard_normal((E * C + 1, x.shape[1])).astype(np.float32)
    h[-1] = 0
    Pb = tmoe.bsr_combine(slot, tope, w_s, keep, T, E, C, torch.float32)
    with juse_backend("plain"):
        jw = jnp.where(jkeep, jw_s, 0.0)
        want = JOp(JCOO(jt_s.astype(jnp.int32), jslot.astype(jnp.int32), jw,
                        (T, E * C + 1))) @ jnp.asarray(h)
    for P in (Pb, comb):
        for backend in ("plain", "cuda"):
            with use_backend(backend):
                np.testing.assert_allclose((SparseOperator(P) @ _t(h)).numpy(), _np(want),
                                           **F32)


# ------------------------------------------------------ fixed-order combine ----


def _index_add_lane(p, x, cfg, m):
    """The 'sort' and 'grouped' lanes as they combined before the fixed-order
    sum: ``index_add_`` over the entries (sort) or the slots (grouped), which
    on the host adds each token's contributions in ascending expert order."""
    T, D = x.shape
    E, K = m.n_experts, m.top_k
    G = m.n_groups if m.dispatch_impl == "grouped" else 1
    Tg = T // G
    C = tmoe._capacity(Tg, K, E, m.capacity_factor)
    if G == 1:
        topw, tope, _ = tmoe._route(p, x, m)
        slot, t_s, w_s, keep = tmoe._dispatch_indices(tope, topw, T, E, K, C)
        xe = torch.zeros((E * C + 1, D), dtype=x.dtype)
        xe[slot] = x[t_s]
        h = tmoe._experts_ffn(p["experts"], xe[: E * C].reshape(E, C, D))
        h_flat = torch.cat([h.reshape(E * C, D), torch.zeros((1, D), dtype=h.dtype)])
        contrib = h_flat[slot] * torch.where(keep, w_s, 0.0)[:, None].to(h.dtype)
        return torch.zeros((T, D), dtype=h.dtype).index_add_(0, t_s, contrib).to(x.dtype)
    x3 = x.reshape(G, Tg, D)
    gates = torch.softmax(x3.float() @ p["router"], dim=-1)
    topw, tope = tmoe.top_k(gates, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    ys = []
    for g in range(G):
        slot, t_s, w_s, keep = tmoe._dispatch_indices(tope[g], topw[g], Tg, E, K, C)
        t_slot = torch.full((E * C + 1,), Tg, dtype=torch.long)
        t_slot[slot] = t_s
        w_slot = torch.zeros((E * C + 1,))
        w_slot[slot] = torch.where(keep, w_s, 0.0)
        t_slot, w_slot = t_slot[: E * C], w_slot[: E * C]
        xpad = torch.cat([x3[g], torch.zeros((1, D), dtype=x.dtype)])
        h = tmoe._experts_ffn_grouped(p["experts"], xpad[t_slot].reshape(1, E, C, D))[0]
        contrib = h.reshape(E * C, D) * w_slot[:, None].to(h.dtype)
        ys.append(torch.zeros((Tg + 1, D), dtype=h.dtype).index_add_(0, t_slot, contrib)[:Tg])
    return torch.stack(ys).reshape(T, D).to(x.dtype)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["sort", "grouped"])
@pytest.mark.parametrize("T,cf", [(96, 4.0), (64, 0.5), (8, 1.25)])
def test_fixed_order_combine_keeps_the_host_bits(dtype, impl, T, cf):
    """The fixed-order combine (no float atomics) gives ``index_add_``'s
    host result bit for bit, at top-6 (a bf16 row is added in f32 and
    rounded once, as ``index_add_`` does on the host), with and without
    drops; the grouped lane over two groups."""
    cfg = T_MOE_CFG.replace(moe=tcfg_base.MoECfg(n_experts=16, top_k=6, d_expert_ff=48))
    m = dataclasses.replace(cfg.moe, capacity_factor=cf, dispatch_impl=impl,
                            n_groups=2 if impl == "grouped" else 0)
    from repro_torch.models.layers import Init
    p = tmoe.init_moe(Init(torch.Generator().manual_seed(7), "cpu"), cfg, m)
    x = torch.randn((T, cfg.d_model), generator=torch.Generator().manual_seed(8)).to(dtype)
    got, _ = tmoe.moe_ffn(p, x, cfg, m)
    assert torch.equal(_bits(got), _bits(_index_add_lane(p, x, cfg, m)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_combine_in_order_is_index_add(dtype):
    """``combine_in_order`` on shuffled entries, wide ranges of magnitude:
    ``index_add_``'s host bits, each token's entries folded in entry order."""
    g = torch.Generator().manual_seed(9)
    T, K, D = 33, 8, 40
    c = (torch.randn(T * K, D, generator=g)
         * torch.exp(3 * torch.randn(T * K, 1, generator=g))).to(dtype)
    t_s = torch.arange(T).repeat_interleave(K)[torch.randperm(T * K, generator=g)]
    want = torch.zeros((T, D), dtype=dtype).index_add_(0, t_s, c)
    assert torch.equal(_bits(tmoe.combine_in_order(c, t_s, T, K)), _bits(want))
