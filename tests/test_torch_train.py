"""The port's train step (``repro_torch.train.steps``) against the
reference's (``repro.train.steps``) on the same weights and batch, and the
autograd path of ``bsr_spmm`` on the card's rules.

The weights cross over with ``params_from_reference``; the batch is numpy
from a seed; both run at f32 activations. Tolerances, each with its reason:
  - loss rtol 1e-5 (each framework's matmuls and softmax round their own);
  - every gradient leaf rtol 1e-4, atol 1e-5 max|g| of the leaf (sums in
    another order, through the MoE lanes' sparse products too);
  - new parameters atol 2 lr: AdamW's first step moves an element by about
    lr times the sign of its gradient, so an element whose gradient is
    below the gradient tolerance may move the other way.
The MoE smoke config runs on the 'sort', 'bsr' and 'coo' lanes; 'bsr' is
also checked for a router gradient from the combine. Remat 'full' (on the
'bsr' lane too, whose recompute runs the sparse products through dispatch
again) and 'dots' give the gradients of no remat.
"""
import dataclasses
import functools
import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.from_reference import params_from_reference
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step
from repro_torch.tree import leaves as tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = "qwen3-moe-235b-a22b"
DENSE = "llama3.2-1b"
OCFG = dict(total_steps=10)
B, S = 4, 16


def _cfgs(arch, lane, remat):
    out = []
    for get in (jget_smoke, get_smoke_config):
        cfg = get(arch).replace(dtype="float32", remat=remat)
        if lane is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=lane))
        out.append(cfg)
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "targets")}


@functools.lru_cache(maxsize=None)
def _reference(arch, lane, remat, microbatches):
    """The reference's loss, gradients (one batch) and new params after
    one ``make_train_step`` over ``microbatches``, as numpy."""
    jcfg, _ = _cfgs(arch, lane, remat)
    model = jbuild(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    loss, grads = jax.value_and_grad(model.loss)(params, batch)
    step = jax.jit(jmake_train_step(model, jadamw.AdamWConfig(**OCFG), microbatches))
    new, opt, metrics = step(params, jadamw.init(params), batch)
    tonp = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (tonp(params), float(loss), tonp(grads), tonp(new),
            {k: float(v) for k, v in metrics.items()})


def _port(arch, lane, remat, params_np):
    _, cfg = _cfgs(arch, lane, remat)
    return cfg, build_model(cfg, device="cpu"), params_from_reference(cfg, params_np,
                                                                      device="cpu")


def _port_grads(model, params, batch):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for t in leaves:
        t.requires_grad_(False)
    return float(loss.detach()), grads


def _tbatch(cfg):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}


CASES = [(MOE, "sort", "none"), (MOE, "bsr", "none"), (MOE, "coo", "none"),
         (MOE, "sort", "dots"), (MOE, "bsr", "full"), (DENSE, None, "none"),
         (DENSE, None, "full")]


@pytest.mark.parametrize("arch,lane,remat", CASES)
def test_gradients_match_reference(arch, lane, remat):
    params_np, jloss, jgrads, _, _ = _reference(arch, lane, remat, 1)
    cfg, model, params = _port(arch, lane, remat, params_np)
    loss, grads = _port_grads(model, params, _tbatch(cfg))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()))
    if lane == "bsr":
        router = params_np["groups"][0]["ffn"]["router"]
        names = [p for p in _paths(params_np)]
        g_router = grads[names.index("groups/0/ffn/router")]
        assert g_router.shape == router.shape and float(g_router.abs().max()) > 0


def _paths(tree, prefix=""):
    """The reference's leaf paths, in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch,lane", [(MOE, "sort"), (MOE, "bsr"), (MOE, "coo"), (DENSE, None)])
def test_train_step_matches_reference(arch, lane, microbatches):
    params_np, _, _, jnew, jm = _reference(arch, lane, "none", microbatches)
    cfg, model, params = _port(arch, lane, "none", params_np)
    ocfg = adamw.AdamWConfig(**OCFG)
    new, opt, m = make_train_step(model, ocfg, microbatches)(params, adamw.init(params),
                                                             _tbatch(cfg))
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), jm["lr"], rtol=1e-6)
    assert int(opt.step) == 1
    atol = 2 * jm["lr"]
    for t, w in zip(tree_leaves(new), jax.tree_util.tree_leaves(jnew)):
        assert not t.requires_grad
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=atol)


def test_microbatch_equivalence():
    """Twin of the reference's ``test_microbatch_equivalence``: gradient
    accumulation over 4 microbatches gives the full batch's update."""
    cfg = get_smoke_config(DENSE)
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab, (8, 32)).astype(np.int32))
             for k in ("tokens", "targets")}
    ocfg = adamw.AdamWConfig(total_steps=10)
    out = []
    for mb in (1, 4):
        params = model.init(0)
        params, _, m = make_train_step(model, ocfg, mb)(params, adamw.init(params), batch)
        out.append((float(m["loss"]), tree_leaves(params)))
    (l1, p1), (l4, p4) = out
    assert abs(l1 - l4) < 1e-5
    for a, b in zip(p1, p4):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=2e-5)


# ------------------------------------------- bsr_spmm's autograd function ----

@pytest.fixture
def card_rules(monkeypatch):
    """``bsr_spmm`` and its backward wrappers take the card's branch on
    host tensors, each launch standing in for its kernel with the plain
    version, so the autograd function's plumbing runs here."""
    mod = importlib.import_module("repro_torch.kernels.bsr_spmm")
    calls = {"spmm": 0, "t": 0, "sddmm": 0}

    def count(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(mod, "_on_card", lambda t: True)
    monkeypatch.setattr(mod, "_launch_spmm", count("spmm", mod.bsr_spmm_plain))
    monkeypatch.setattr(mod, "_launch_spmm_t", count(
        "t", lambda bcols, blocks, dY, ncols, work: mod.bsr_spmm_t_plain(bcols, blocks, dY,
                                                                        ncols)))
    monkeypatch.setattr(mod, "_launch_sddmm", count(
        "sddmm", lambda bcols, dY, X, bs, work: mod.bsr_sddmm_plain(bcols, dY, X, bs)))
    return mod, calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_bsr_spmm_function_gives_plain_autograd(card_rules, dtype, masked):
    mod, calls = card_rules
    g = torch.Generator().manual_seed(0)
    bs, nbrows, bwidth, ncols, nf = 8, 5, 3, 29, 6
    bcols = torch.randint(-1, 5, (nbrows, bwidth), generator=g).int()
    blocks = torch.randn((nbrows, bwidth, bs, bs), generator=g).to(dtype)
    X = torch.randn((ncols, nf), generator=g).to(dtype)
    dY = torch.randn((nbrows * bs, nf), generator=g)
    mask = (torch.rand(nbrows * bs, generator=g) < 0.5) if masked else None
    out = []
    for fn in (mod.bsr_spmm, mod.bsr_spmm_plain):
        b, x = blocks.clone().requires_grad_(), X.clone().requires_grad_()
        Y = fn(bcols, b, x, mask)
        gx, gb = torch.autograd.grad(Y, (x, b), dY)
        assert gx.dtype == dtype and gb.dtype == dtype
        out.append((Y.detach(), gx, gb))
    assert calls == {"spmm": 1, "t": 1, "sddmm": 1}
    for a, b in zip(*out):
        assert torch.equal(a, b)
    with torch.no_grad():
        mod.bsr_spmm(bcols, blocks, X)
    assert calls["spmm"] == 2 and calls["t"] == 1


def test_bsr_lane_router_gradient_through_the_function(card_rules):
    """The MoE 'bsr' lane on the card's rules: both products take the
    function, the dispatch asks for dX only and the combine for dX and dB,
    and the router's gradient is the plain lane's."""
    from repro_torch.core import use_backend
    from repro_torch.models import moe as tmoe
    from repro_torch.models.layers import Init

    mod, calls = card_rules
    cfg = get_smoke_config(MOE).replace(dtype="float32")
    mcfg = dataclasses.replace(cfg.moe, dispatch_impl="bsr", capacity_factor=4.0)
    p = tmoe.init_moe(Init(torch.Generator().manual_seed(0), "cpu"), cfg, mcfg)
    x = torch.randn((24, cfg.d_model), generator=torch.Generator().manual_seed(1))
    grads = []
    for backend in ("cuda", "plain"):
        r = p["router"].clone().requires_grad_()
        xi = x.clone().requires_grad_()
        with use_backend(backend):
            y, aux = tmoe.moe_ffn({"router": r, "experts": p["experts"]}, xi, cfg, mcfg)
        grads.append(torch.autograd.grad((y * y).sum(), (r, xi)))
    assert calls == {"spmm": 2, "t": 2, "sddmm": 1}
    for a, b in zip(*grads):
        assert float(a.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["pads_and_ids_past_the_end", "long_runs", "empty_columns"])
def test_backward_work_list_matches_numpy(case):
    """The work list both backward kernels walk: the flat slots sorted
    stably by block column, pads (id < 0 or >= nbcols) last, each column's
    run bounds, against a numpy construction; the kernels' wrappers take
    it only at the lengths their grids need."""
    mod = importlib.import_module("repro_torch.kernels.bsr_spmm")
    rng = np.random.default_rng(3)
    if case == "pads_and_ids_past_the_end":
        nbcols, bcols = 5, rng.integers(-2, 8, (9, 4))
    elif case == "long_runs":
        nbcols, bcols = 2, np.tile([[0, 1]], (150, 1))
    else:
        nbcols, bcols = 8, np.array([[r, -1] for r in range(5)])
    order, starts = mod.bsr_column_order(torch.from_numpy(bcols.astype(np.int32)), nbcols)
    assert order.dtype == torch.int32 and starts.dtype == torch.int32
    keys = bcols.reshape(-1)
    keys = np.where((keys >= 0) & (keys < nbcols), keys, nbcols)
    np.testing.assert_array_equal(order.numpy(), np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(starts.numpy(),
                                  np.searchsorted(np.sort(keys), np.arange(nbcols + 1)))
    assert mod._work_list("bsr_sddmm", (order, starts), bcols.size, nbcols)[1] is starts
    for nslots, nb in ((bcols.size, nbcols + 1), (bcols.size + 1, nbcols)):
        with pytest.raises(ValueError, match="work list of"):
            mod._work_list("bsr_sddmm", (order, starts), nslots, nb)


def test_no_grad_guard_names_the_kernel():
    from repro_torch.kernels._launch import no_grad_operands

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="dia_spmv: the CUDA kernel has no backward"):
        no_grad_operands("dia_spmv", None, x)
    with torch.no_grad():
        no_grad_operands("dia_spmv", None, x)
    no_grad_operands("dia_spmv", torch.ones(3), None)


def test_launcher_trains_on_the_host(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                        "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                        "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "final loss" in r.stdout and "device=cpu" in r.stdout
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_000000002",
                                                              "step_000000003"]


def test_remat_recompute_keeps_the_forward_policy():
    """On a CUDA device autograd recomputes a checkpointed layer on its own
    thread, where the ambient policy (per thread) is the default: the
    recompute re-enters the forward's, so the MoE lane's products take the
    same backend twice. Here the backward runs on another thread."""
    import threading

    from repro_torch.core import use_backend

    spmv_mod = sys.modules["repro_torch.core.spmv"]
    seen = []
    orig = spmv_mod._dispatch_spmm

    def record(A, X, policy):
        seen.append((threading.get_ident(), policy.backends))
        return orig(A, X, policy)

    cfg = get_smoke_config(MOE).replace(remat="full", dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl="bsr"))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(1, cfg.vocab, (2, 16), generator=g) for k in ("tokens", "targets")}
    spmv_mod._dispatch_spmm = record
    try:
        with use_backend("dense"):
            loss = model.loss(params, batch)
        out = []
        th = threading.Thread(target=lambda: out.append(torch.autograd.grad(loss, leaves)))
        th.start()
        th.join()
    finally:
        spmv_mod._dispatch_spmm = orig
    assert len(out) == 1
    assert len({t for t, _ in seen}) == 2  # the forward's thread and the backward's
    assert {b for _, b in seen} == {("dense", "plain")}
