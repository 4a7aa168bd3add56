"""The MoE layer's lanes and the model families on the card (``-m cuda``;
skipped without one).

Imports no JAX: the card's machine has none. Each lane's kernels run on
CUDA tensors at a mid width (d_model 512, 32 experts, top-4) and hold to
the 'sort' lane on the card and to the port's own result on the host, at
the reference's MoE contract (``tests/test_moe.py``: f32 ``rtol=1e-4,
atol=1e-5``, aux ``rtol=1e-5``). The dispatch matrices give X's rows back
bit for bit. Every lane gives equal bits over two runs: the bsr and coo
kernels add in a fixed order, and the sort and grouped lanes combine with
a fixed-order sum (no float atomics), the twin of the reference's
``test_no_drops_at_high_capacity``. Each model family is served at smoke
size on the card and held to the port's own result on the host.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import SparseOperator, use_backend
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_path
from repro_torch.kernels.coo_spmv import coo_spmv, coo_spmv_plain
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Init

tcfg_base = importlib.import_module("repro_torch.configs.base")

F32 = dict(rtol=1e-4, atol=1e-5)
CFG = tcfg_base.ModelConfig(name="mid", family="moe", n_layers=1, d_model=512, n_heads=8,
                            n_kv_heads=8, d_ff=1024, vocab=64,
                            moe=tcfg_base.MoECfg(n_experts=32, top_k=4, d_expert_ff=256))
#: (T, capacity_factor): decode-like T below the block edge, drops, none.
CASES = [(4, 1.25), (96, 0.5), (128, 4.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _setup(T, cf, device):
    mcfg = dataclasses.replace(CFG.moe, capacity_factor=cf)
    p = tmoe.init_moe(Init(torch.Generator().manual_seed(0), "cpu"), CFG, mcfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((T, CFG.d_model))
                         .astype(np.float32))
    on = {k: v.to(device) for k, v in p.items() if k != "experts"}
    on["experts"] = {k: v.to(device) for k, v in p["experts"].items()}
    return p, on, x, mcfg


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T,cf", CASES)
@pytest.mark.parametrize("impl", ["onehot", "coo", "bsr", "grouped"])
def test_moe_lanes_on_card(cuda, T, cf, impl):
    if impl == "coo" and T > 4:
        T = 16  # the coo lane runs one SpMV per column of X: 512 launches a product
    p, pc, x, mcfg = _setup(T, cf, cuda)
    m = dataclasses.replace(mcfg, dispatch_impl=impl, n_groups=2 if impl == "grouped" else 0)
    sort_m = dataclasses.replace(mcfg, dispatch_impl="sort")
    before = {"bsr": bsr_spmm.launches, "coo": coo_spmv.launches}
    with use_backend("cuda"):
        y, aux = tmoe.moe_ffn(pc, x.to(cuda), CFG, m)
        y_sort, aux_sort = tmoe.moe_ffn(pc, x.to(cuda), CFG, sort_m)
        y_host, aux_host = tmoe.moe_ffn(p, x, CFG, m)
    if impl == "bsr":
        assert bsr_spmm.launches == before["bsr"] + 2
    if impl == "coo":
        assert coo_spmv.launches == before["coo"] + 2 * CFG.d_model
    if impl != "grouped":
        _close(y, y_sort, **F32)
        np.testing.assert_allclose(float(aux), float(aux_sort), rtol=1e-5)
    _close(y, y_host, **F32)
    np.testing.assert_allclose(float(aux), float(aux_host), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T,cf", CASES)
def test_moe_dispatch_exact_and_repeatable_on_card(cuda, T, cf):
    """The bsr and coo dispatch matrices give the sort lane's ``xe`` bit
    for bit on the card; the bsr lane (and the coo lane at a small T) give
    equal bits over two launches; the coo combine's unsorted rows equal
    its plain version."""
    _, pc, x, mcfg = _setup(T, cf, cuda)
    xc = x.to(cuda)
    E, K = mcfg.n_experts, mcfg.top_k
    C = tmoe._capacity(T, K, E, cf)
    topw, tope, _ = tmoe._route(pc, xc, mcfg)
    slot, t_s, w_s, keep = tmoe._dispatch_indices(tope, topw, T, E, K, C)
    xe = torch.zeros((E * C + 1, x.shape[1]), device=cuda)
    xe[slot] = xc[t_s]
    with use_backend("cuda"):
        Pb = tmoe.bsr_dispatch(slot, t_s, keep, T, E, C, torch.float32)
        assert torch.equal(SparseOperator(Pb) @ xc, xe[: E * C])
        Pc = tmoe.coo_dispatch(slot, t_s, keep, T, E, C, torch.float32)
        assert torch.equal(SparseOperator(Pc) @ xc[:, :8], xe[: E * C, :8])
        comb = tmoe.coo_combine(slot, t_s, w_s, keep, T, E, C, torch.float32)
        h = torch.randn((E * C + 1,), generator=torch.Generator().manual_seed(2)).to(cuda)
        h[-1] = 0
        y = SparseOperator(comb) @ h
        assert torch.equal(y, coo_spmv_plain(comb.row, comb.col, comb.val, h, T))
        m = dataclasses.replace(mcfg, dispatch_impl="bsr")
        assert torch.equal(tmoe.moe_ffn(pc, xc, CFG, m)[0], tmoe.moe_ffn(pc, xc, CFG, m)[0])
        if T <= 16:
            m = dataclasses.replace(mcfg, dispatch_impl="coo")
            assert torch.equal(tmoe.moe_ffn(pc, xc, CFG, m)[0],
                               tmoe.moe_ffn(pc, xc, CFG, m)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("nf", [1, 8, 4096])
def test_moe_block_edge_runs_on_cuda_cores(cuda, nf):
    """The MoE lanes' 8x8 blocks take the CUDA-core path at every width,
    where fused multiply-adds by 0 and 1 keep X's bits."""
    assert bsr_spmm_path(8, nf) == "cuda-core"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["sort", "grouped"])
def test_no_drops_at_high_capacity_on_card(cuda, impl, dtype):
    """The reference's ``test_no_drops_at_high_capacity`` on the card: the
    default lane (and the grouped one, over two groups) run twice on the
    same input give equal arrays."""
    _, pc, x, mcfg = _setup(128, 8.0, cuda)
    m = dataclasses.replace(mcfg, dispatch_impl=impl, n_groups=2 if impl == "grouped" else 0)
    xc = x.to(cuda, dtype)
    y1, _ = tmoe.moe_ffn(pc, xc, CFG, m)
    y1b, _ = tmoe.moe_ffn(pc, xc, CFG, m)
    assert y1.shape == xc.shape and y1.dtype == dtype
    assert bool(torch.isfinite(y1).all())
    assert torch.equal(y1, y1b)


def _to(tree, device):
    from repro_torch.models.model import tree_map
    return tree_map(lambda t: t.to(device), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl", [("deepseek-v2-236b", "bsr"), ("jamba-v0.1-52b", "bsr"),
                                       ("rwkv6-7b", None), ("whisper-base", None)])
def test_new_families_serve_on_card(cuda, arch, impl):
    """``serve_lm`` at smoke size in f32 on the card against the same
    weights served on the host: equal greedy tokens, every step's logits
    at ``rtol=1e-4`` with an atol of ``1e-5 * max|logit|``; the MoE
    families on the bsr lane launch ``bsr_spmm``."""
    import types

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as tserve

    args = types.SimpleNamespace(arch=arch, smoke=True, batch=2, prompt_len=5, gen=4, seed=1,
                                 layers=0, dispatch_impl=impl, device="cpu", graph=False)
    get = tserve.get_smoke_config
    tserve.get_smoke_config = lambda a: get_smoke_config(a).replace(dtype="float32")
    try:
        cfg = tserve.lm_config(args)
        from repro_torch.models import build_model
        params = build_model(cfg, "cpu").init(3)
        host_logits, card_logits = [], []
        host = tserve.serve_lm(args, params=params, logits_out=host_logits)
        before = bsr_spmm.launches
        card = tserve.serve_lm(types.SimpleNamespace(**{**vars(args), "device": "cuda"}),
                               params=_to(params, cuda), logits_out=card_logits)
    finally:
        tserve.get_smoke_config = get
    if impl == "bsr":
        assert bsr_spmm.launches > before
    assert torch.equal(card["generated"], host["generated"])
    for a, b in zip(card_logits, host_logits):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5 * scale)
