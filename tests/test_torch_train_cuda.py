"""Training on the card (``-m cuda``; skipped without one): ``bsr_spmm``'s
backward kernels, the refusal of every other CUDA wrapper to cut a graph,
the MoE 'bsr' lane's gradients, ``bsr_linear``'s gradients, and the trainer
at smoke size.

Imports no JAX: the card's machine has none. The backward kernels
(``bsr_spmm_t``: dX = A^T dY; ``bsr_sddmm``: dB = dY X^T at the stored
blocks) hold to their plain versions, and autograd through ``bsr_spmm`` on
the card holds to autograd through ``bsr_spmm_plain`` there, at the f32
conformance tolerance (rtol 2e-4, atol 2e-4 max|want|: the kernels sum in
another order than the plain batched matmul); two launches give equal bits.
"""
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from repro_torch.core import SparseOperator, as_operator, use_backend
from repro_torch.core.errors import KernelExecutionError
from repro_torch.kernels.bsr_spmm import (bsr_sddmm, bsr_sddmm_plain, bsr_spmm,
                                          bsr_spmm_plain, bsr_spmm_t, bsr_spmm_t_plain)
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Init

tcfg_base = importlib.import_module("repro_torch.configs.base")

# cuBLAS repeats its bits under the trainer's deterministic mode only with
# this workspace setting, which it reads before the process's first product:
# set here, at collection, before any test runs one.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

KERNEL_TOL = 2e-4
#: The reference's MoE gradient bound (``tests/test_moe.py``: atol 1e-3).
MOE_GRAD_ATOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _close(got, want, tol=KERNEL_TOL):
    got, want = got.double(), want.double().to(got.device)
    assert torch.isfinite(got).all()
    atol = tol * max(float(want.abs().max()), 1e-30)
    err = (got - want).abs()
    assert bool((err <= atol + tol * want.abs()).all()), float(err.max())


def _bsr_case(bs, dtype, nf, device, seed=0, nbrows=6, bwidth=3):
    """BSR arrays with pads (-1) and out-of-range ids (>= nbcols), ``ncols``
    not a multiple of ``bs``, and a row mask that keeps about half the rows."""
    g = torch.Generator().manual_seed(seed)
    ncols = 4 * bs - 3
    nbcols = -(-ncols // bs)
    bcols = torch.randint(-1, nbcols + 1, (nbrows, bwidth), generator=g).int()
    bcols[0, 0], bcols[1, 0] = 0, nbcols - 1  # the ragged last column is read
    blocks = torch.randn((nbrows, bwidth, bs, bs), generator=g).to(dtype)
    X = torch.randn((ncols, nf), generator=g)
    dY = torch.randn((nbrows * bs, nf), generator=g)
    mask = torch.rand((nbrows * bs,), generator=g) < 0.5
    return [t.to(device) for t in (bcols, blocks, X, dY, mask)]


def _blocks_of(A, bs, dtype):
    """``(bcols, blocks)`` of a dense ``(nbrows * bs, ncols)`` matrix: each
    block row's nonzero blocks in ascending column, padded with -1."""
    nbrows, nbcols = A.shape[0] // bs, -(-A.shape[1] // bs)
    Ap = torch.zeros((nbrows * bs, nbcols * bs))
    Ap[:, :A.shape[1]] = A
    tiles = Ap.reshape(nbrows, bs, nbcols, bs).permute(0, 2, 1, 3)
    cols = [torch.nonzero(tiles[r].abs().sum((1, 2))).flatten() for r in range(nbrows)]
    bwidth = max(1, max(len(c) for c in cols))
    bcols = torch.full((nbrows, bwidth), -1, dtype=torch.int32)
    blocks = torch.zeros((nbrows, bwidth, bs, bs))
    for r, c in enumerate(cols):
        bcols[r, :len(c)] = c.int()
        blocks[r, :len(c)] = tiles[r, c]
    return bcols, blocks.to(dtype)


def _layout_case(layout, bs, dtype, nf, device, seed=0):
    """:func:`_bsr_case`'s arrays, or a layout that walks the kernels' edges:
    ``long_runs``, two block columns of 80 blocks each (longer than a staged
    batch or chunk, as the MoE dispatch's runs of ~64); ``overflow_column``,
    most slots of every block row in the last, ragged column (a run of 266,
    many chunks, beside runs of 8: the MoE combine's column of dropped
    picks); ``many_columns``, 1,100 block columns, more than the 1,024 the
    C entries' chunk prefix scans at a time, with a run of 80 in column
    1,090; ``single_runs``, a
    run of one block in each of the first five columns and three empty ones
    (the last ragged); ``one_hot``, at most one entry a row, ones (the
    dispatch's kind); ``unaligned``, :func:`_bsr_case` with dY and X one
    float off a 16-byte boundary."""
    if layout in ("random", "unaligned"):
        case = _bsr_case(bs, dtype, nf, device, seed)
        if layout == "unaligned":
            for i in (2, 3):
                buf = torch.empty(case[i].numel() + 1, device=device)
                case[i] = buf[1:].view(case[i].shape).copy_(case[i])
                assert case[i].data_ptr() % 16
        return case
    g = torch.Generator().manual_seed(seed)
    if layout == "long_runs":
        nbrows, ncols = 80, 2 * bs - 1
        bcols = torch.tensor([[0, 1]] * nbrows, dtype=torch.int32)
        bcols[7, 1] = -1  # a pad inside the run's block rows
        blocks = torch.randn((nbrows, 2, bs, bs), generator=g).to(dtype)
    elif layout == "overflow_column":
        nbrows, ncols = 40, 6 * bs - 5
        bcols = torch.full((nbrows, 8), 5, dtype=torch.int32)
        bcols[:, 0] = torch.arange(nbrows) % 5
        bcols[::3, 7] = -1
        blocks = torch.randn((nbrows, 8, bs, bs), generator=g).to(dtype)
    elif layout == "many_columns":
        nbrows, ncols = 80, 1100 * bs - 3
        bcols = torch.randint(0, 1100, (nbrows, 8), generator=g).int()
        bcols[:, 7] = 1090
        bcols[::5, 3] = -1
        blocks = torch.randn((nbrows, 8, bs, bs), generator=g).to(dtype)
    elif layout == "single_runs":
        nbrows, ncols = 5, 8 * bs - 3
        bcols = torch.tensor([[r, -1] for r in range(nbrows)], dtype=torch.int32)
        blocks = torch.randn((nbrows, 2, bs, bs), generator=g).to(dtype)
    else:  # one_hot
        nbrows, ncols = 12, 10 * bs - 5
        A = torch.zeros((nbrows * bs, ncols))
        rows = torch.nonzero(torch.rand(nbrows * bs, generator=g) < 0.8).flatten()
        A[rows, torch.randint(0, ncols, (len(rows),), generator=g)] = 1.0
        bcols, blocks = _blocks_of(A, bs, dtype)
    X = torch.randn((ncols, nf), generator=g)
    dY = torch.randn((nbrows * bs, nf), generator=g)
    mask = torch.rand((nbrows * bs,), generator=g) < 0.5
    return [t.to(device) for t in (bcols, blocks, X, dY, mask)]


def _autograd_plain(bcols, blocks, X, dY, mask):
    """dX and dB by autograd through ``bsr_spmm_plain`` (f32 blocks, so dB
    is not rounded to the blocks' dtype)."""
    x = X.clone().requires_grad_()
    b = blocks.float().requires_grad_()
    return torch.autograd.grad(bsr_spmm_plain(bcols, b, x, mask), (x, b), dY)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["random", "long_runs", "overflow_column", "many_columns",
                                    "single_runs", "one_hot", "unaligned"])
@pytest.mark.parametrize("nf", [1, 8, 128, 131, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_backward_kernels_match_plain_and_repeat(cuda, bs, dtype, nf, layout):
    """Each kernel against its plain version and against autograd through
    ``bsr_spmm_plain`` (the row mask applied to dY, as the autograd
    function does), with pads, ids past the last column and a ragged last
    column, on each layout of :func:`_layout_case` (nf 1 and 131 leave a
    tail short of 16 bytes); two launches give equal bits."""
    bcols, blocks, X, dY, mask = _layout_case(layout, bs, dtype, nf, cuda)
    ncols = X.shape[0]
    t0, s0 = bsr_spmm_t.launches, bsr_sddmm.launches
    dX = bsr_spmm_t(bcols, blocks, dY, ncols)
    dB = bsr_sddmm(bcols, dY, X, bs)
    torch.cuda.synchronize()
    assert bsr_spmm_t.launches == t0 + 1 and bsr_sddmm.launches == s0 + 1
    assert dX.shape == (ncols, nf) and dB.shape == blocks.shape
    _close(dX, bsr_spmm_t_plain(bcols, blocks, dY, ncols))
    _close(dB, bsr_sddmm_plain(bcols, dY, X, bs))
    pad = (bcols < 0) | (bcols >= -(-ncols // bs))
    assert bool((dB[pad] == 0).all())
    assert torch.equal(dX, bsr_spmm_t(bcols, blocks, dY, ncols))
    assert torch.equal(dB, bsr_sddmm(bcols, dY, X, bs))
    dYm = torch.where(mask[:, None], dY, torch.zeros((), device=cuda))
    gx, gb = _autograd_plain(bcols, blocks, X, dY, mask)
    _close(bsr_spmm_t(bcols, blocks, dYm, ncols), gx)
    _close(bsr_sddmm(bcols, dYm, X, bs), gb)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_bsr_spmm_autograd_on_card_matches_plain(cuda, bs, dtype, masked):
    """``bsr_spmm`` on tensors that require grad keeps a ``grad_fn``, runs
    both backward kernels once, and gives the gradients autograd gives
    through ``bsr_spmm_plain``, in the operands' dtypes."""
    bcols, blocks, X, dY, mask = _bsr_case(bs, dtype, 128, cuda, seed=1)
    mask = mask if masked else None
    Xd = X.to(dtype)
    grads = []
    for fn in (bsr_spmm, bsr_spmm_plain):
        b = blocks.clone().requires_grad_()
        x = Xd.clone().requires_grad_()
        Y = fn(bcols, b, x, mask)
        assert Y.grad_fn is not None
        t0, s0 = bsr_spmm_t.launches, bsr_sddmm.launches
        gx, gb = torch.autograd.grad(Y, (x, b), dY)
        if fn is bsr_spmm:
            assert (bsr_spmm_t.launches, bsr_sddmm.launches) == (t0 + 1, s0 + 1)
        assert gx.dtype == dtype and gb.dtype == dtype
        grads.append((gx, gb))
    (gx, gb), (px, pb) = grads
    tol = KERNEL_TOL if dtype is torch.float32 else 8 * torch.finfo(dtype).eps
    _close(gx, px, tol)
    _close(gb, pb, tol)


@pytest.mark.cuda
def test_bsr_spmm_only_computes_the_gradients_asked_for(cuda):
    bcols, blocks, X, dY, _ = _bsr_case(8, torch.float32, 64, cuda, seed=2)
    x = X.clone().requires_grad_()
    t0, s0 = bsr_spmm_t.launches, bsr_sddmm.launches
    (gx,) = torch.autograd.grad(bsr_spmm(bcols, blocks, x), (x,), dY)
    assert (bsr_spmm_t.launches, bsr_sddmm.launches) == (t0 + 1, s0)
    b = blocks.clone().requires_grad_()
    (gb,) = torch.autograd.grad(bsr_spmm(bcols, b, X), (b,), dY)
    assert (bsr_spmm_t.launches, bsr_sddmm.launches) == (t0 + 1, s0 + 1)
    with torch.no_grad():
        assert bsr_spmm(bcols, b, x).grad_fn is None


def _matrix(n=512):
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    s = sp.random(n, n, density=0.02, format="csr", random_state=rng, dtype=np.float32)
    return (s + sp.eye(n, dtype=np.float32) + sp.eye(n, k=1, dtype=np.float32)).tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("fmt", ["coo", "csr", "dia", "ell", "sell"])
def test_other_cuda_wrappers_refuse_an_operand_that_requires_grad(cuda, fmt, tiled):
    """Every CUDA kernel but ``bsr_spmm`` has no backward: with grad mode on
    and an operand that requires grad its launch raises (dispatch wraps it
    in ``KernelExecutionError``) instead of returning a detached result,
    resident and column-tiled (a 128-column limit), SpMV, SpMM and masked;
    under ``torch.no_grad()`` the same product runs."""
    from repro_torch.core import ExecutionPolicy

    pol = ExecutionPolicy(max_resident_cols=128) if tiled else None
    op = as_operator(_matrix(), fmt, policy=pol, device="cuda").using("cuda", fallback=False)
    x = torch.randn(512, device=cuda, requires_grad=True)
    mask = torch.arange(512, device=cuda) % 3 == 0
    for call in (lambda: op @ x,
                 lambda: op @ torch.randn((512, 3), device=cuda, requires_grad=True),
                 lambda: op.masked_matvec(x, mask)):
        with pytest.raises(KernelExecutionError, match="no backward"):
            call()
    with torch.no_grad():
        y = op @ x
    assert y.grad_fn is None and torch.isfinite(y).all()


@pytest.mark.cuda
def test_sliced_coo_refuses_an_operand_that_requires_grad(cuda):
    from repro_torch.kernels.coo_spmv import build_scoo, scoo_spmv

    s = _matrix().tocoo()
    row, col, val, sid = (torch.from_numpy(a).to(cuda) for a in build_scoo(
        s.row.astype(np.int32), s.col.astype(np.int32), s.data, s.shape[0]))
    x = torch.randn(512, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        scoo_spmv(row, col, val, sid, x, nrows=512)


MOE = tcfg_base.ModelConfig(name="mid", family="moe", n_layers=1, d_model=256, n_heads=8,
                            n_kv_heads=8, d_ff=512, vocab=64,
                            moe=tcfg_base.MoECfg(n_experts=16, top_k=4, d_expert_ff=128))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 96])
def test_bsr_lane_gradients_match_sort_on_card(cuda, T):
    """The 'bsr' lane on ``use_backend("cuda")`` at a capacity where no
    pick drops: output, aux and every gradient (x, router, experts) within
    the reference's MoE bound of 'sort'; the router's gradient reaches it
    through the combine's block values, not only through aux."""
    mcfg = dataclasses.replace(MOE.moe, capacity_factor=MOE.moe.n_experts / MOE.moe.top_k)
    p = tmoe.init_moe(Init(torch.Generator(device=cuda).manual_seed(0), cuda), MOE, mcfg)
    x0 = torch.randn((T, MOE.d_model), generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda)
    out = {}
    for impl in ("sort", "bsr"):
        leaves = {"x": x0.clone(), "router": p["router"].clone(),
                  **{k: v.clone() for k, v in p["experts"].items()}}
        for t in leaves.values():
            t.requires_grad_()
        lp = {"router": leaves["router"],
              "experts": {k: leaves[k] for k in p["experts"]}}
        t0 = bsr_spmm_t.launches
        with use_backend("cuda"):
            y, aux = tmoe.moe_ffn(lp, leaves["x"], MOE,
                                  dataclasses.replace(mcfg, dispatch_impl=impl))
            assert y.grad_fn is not None
            g_aux = torch.autograd.grad(aux, leaves["router"], retain_graph=True)[0]
            g = torch.autograd.grad((y * y).sum() + aux, list(leaves.values()))
        if impl == "bsr":
            assert bsr_spmm_t.launches == t0 + 2  # the dispatch's dX and the combine's
        out[impl] = (y, dict(zip(leaves, g)), g_aux)
    (ys, gs, _), (yb, gb, g_aux) = out["sort"], out["bsr"]
    np.testing.assert_allclose(yb.detach().cpu().numpy(), ys.detach().cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    for k in gs:
        np.testing.assert_allclose(gb[k].cpu().numpy(), gs[k].cpu().numpy(), rtol=1e-4,
                                   atol=MOE_GRAD_ATOL, err_msg=k)
    assert float((gb["router"] - g_aux).abs().max()) > 0  # the combine carries gates


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [4, 128])
def test_bsr_linear_gradients_on_card(cuda, tokens):
    """``bsr_linear`` at bs 32 (the tensor-core forward from 8 tokens on):
    the input's and the kept blocks' gradients against the plain lane."""
    from repro_torch import sparsify

    w = torch.randn((256, 192), generator=torch.Generator().manual_seed(0))
    A = sparsify.prune_linear_to_bsr(w, density=0.5, bs=32, device=cuda)
    x0 = torch.randn((tokens, 256), generator=torch.Generator().manual_seed(1)).to(cuda)
    grads = {}
    for impl in ("cuda", "plain"):
        blocks = A.blocks.clone().requires_grad_()
        x = x0.clone().requires_grad_()
        B = dataclasses.replace(A, blocks=blocks)
        y = sparsify.bsr_linear(B, x, impl=impl)
        grads[impl] = torch.autograd.grad((y * y).sum(), (x, blocks))
    for got, want in zip(grads["cuda"], grads["plain"]):
        _close(got, want)


def _trainer(tmp_path, name, steps=12, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl="bsr"))
    return Trainer(cfg, TrainerConfig(n_steps=steps, global_batch=2, seq_len=32,
                                      ckpt_dir=str(tmp_path / name), checkpoint_every=4,
                                      log_every=100, **kw), device="cuda")


@pytest.mark.cuda
def test_trainer_restart_on_card(cuda, tmp_path):
    """The twin of ``test_failure_restart_is_bitexact`` on the card, on the
    MoE 'bsr' lane under ``use_backend("cuda")``: a failure at step 10
    restores step 8's checkpoint and replays; losses at 8, 9 and 11 agree
    with the run without it within the reference's 1e-6, and the backward
    kernels ran."""
    t0 = bsr_sddmm.launches
    with use_backend("cuda"):
        h1 = _trainer(tmp_path, "a").train()
        h2 = _trainer(tmp_path, "b").train(fail_at=10)
    assert bsr_sddmm.launches > t0
    l1 = [h["loss"] for h in h1]
    l2 = {}
    for h in h2:
        l2[h["step"]] = h["loss"]
    for s in (8, 9, 11):
        assert abs(l1[s] - l2[s]) < 1e-6, (s, l1[s], l2[s])


@pytest.mark.cuda
def test_microbatch_equivalence_on_card(cuda):
    """Gradient accumulation over 4 microbatches gives the full batch's
    update on the card (the reference's bound: loss 1e-5, params 2e-5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    cfg = get_smoke_config("llama3.2-1b")
    model = build_model(cfg, device="cuda")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab, (8, 32)).astype(np.int32)).to(cuda)
             for k in ("tokens", "targets")}
    ocfg = adamw.AdamWConfig(total_steps=10)
    out = []
    for mb in (1, 4):
        params = model.init(0)
        opt = adamw.init(params)
        params, _, m = make_train_step(model, ocfg, mb)(params, opt, batch)
        out.append((float(m["loss"]), tree_leaves(params)))
    (l1, p1), (l4, p4) = out
    assert abs(l1 - l4) < 1e-5
    for a, b in zip(p1, p4):
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(), atol=2e-5)



@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_no_remat_on_card(cuda, remat):
    """The MoE smoke config on the 'bsr' lane under ``use_backend("cuda")``:
    the recomputed layer runs the same routing and kernels, so the loss and
    every gradient equal those without remat."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    out = []
    for mode in ("none", remat):
        cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(remat=mode, dtype="float32")
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl="bsr"))
        model = build_model(cfg, device="cuda")
        params = model.init(0)
        leaves = adamw.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(1, cfg.vocab, (2, 16), generator=g).to(cuda)
                 for k in ("tokens", "targets")}
        with use_backend("cuda"):
            loss = model.loss(params, batch)
            out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert float(l0) == float(l1)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(), rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_every_leaf_gets_its_gradient_on_card(cuda):
    """The MoE smoke config (f32) on the 'bsr' lane: every parameter leaf's
    gradient on the card under ``use_backend("cuda")`` holds to the host's
    plain lane (rtol 1e-4, atol 1e-5 max|g|), so no product cut the graph."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl="bsr"))
    params = build_model(cfg, device="cpu").init(0)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(1, cfg.vocab, (2, 16), generator=g) for k in ("tokens", "targets")}
    out = []
    for dev, backend in (("cpu", "plain"), ("cuda", "cuda")):
        p = adamw.tree_map(lambda t: t.to(dev), params)
        leaves = adamw.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        with use_backend(backend):
            loss = build_model(cfg, device=dev).loss(p, {k: v.to(dev) for k, v in batch.items()})
            out.append(torch.autograd.grad(loss, leaves))
    for want, got in zip(*out):
        w = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))
