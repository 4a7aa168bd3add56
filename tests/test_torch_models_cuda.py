"""The MoE layer's lanes on the card (``-m cuda``; skipped without one).

Imports no JAX: the card's machine has none. Each lane's kernels run on
CUDA tensors at a mid width (d_model 512, 32 experts, top-4) and hold to
the 'sort' lane on the card and to the port's own result on the host, at
the reference's MoE contract (``tests/test_moe.py``: f32 ``rtol=1e-4,
atol=1e-5``, aux ``rtol=1e-5``). The dispatch matrices give X's rows back
bit for bit; the bsr and coo lanes give equal bits over two launches
(their kernels add in a fixed order; the sort lane's ``index_add_`` does
not).
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
