"""The distributed SpMV layer on the card: four parts of HPCG 26^3 on one
CUDA device (imports no JAX: the card's machine has none).

  - dia+coo, ell+coo, csr+csr and ell+dia (each on its ``cuda`` keys; the
    last puts DIA on the rectangular remote windows, as the tuner does)
    agree with the port's serial csr/plain SpMV at rtol 2e-4 (an atol of
    2e-4 ||y||_inf);
  - the masked matvec equals ``where(mask, A @ x, 0)`` of the same keys
    exactly (the row mask rides into the dia and ell kernels);
  - ``rowblock`` csr/plain equals the serial csr/plain SpMV bit for bit;
  - ``dia_spmv``, ``ell_spmv`` and ``coo_spmv`` launch on the parts (26^3
    parts have 4,394 rows, under ``max_onehot_rows``), while stacked csr has
    no ``"scs"`` plan and dispatch runs ``csr/plain``;
  - the per-partition tuner over plain and cuda keys gives a result within
    the same tolerance.

Every test skips without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DispatchKey, PartMesh, as_operator
from repro_torch.core import matrices as M
from repro_torch.core.spmv import select_spmv
from repro_torch.distributed_op import DistributedOperator, tune_partitions
from repro_torch.kernels.coo_spmv import coo_spmv
from repro_torch.kernels.dia_spmv import dia_spmv
from repro_torch.kernels.ell_spmv import ell_spmv
from repro_torch.solvers import SymGS

pytestmark = pytest.mark.cuda

GRID = 26
PAIRS = {"dia+coo": (("dia", "cuda"), ("coo", "cuda")),
         "ell+coo": (("ell", "cuda"), ("coo", "cuda")),
         "csr+csr": (("csr", "cuda"), ("csr", "cuda")),
         "ell+dia": (("ell", "cuda"), ("dia", "cuda"))}
LAUNCHES = {"dia+coo": (dia_spmv, coo_spmv), "ell+coo": (ell_spmv, coo_spmv),
            "csr+csr": (), "ell+dia": (ell_spmv, dia_spmv)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    s = M.fdm27(GRID, GRID, GRID)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(s.shape[0])
                         .astype(np.float32)).cuda()
    serial = as_operator(s, "csr", device="cuda").using("plain")
    return PartMesh.on("cuda", parts=4), s, x, serial


def _within(y, want, rtol=2e-4):
    y, want = y.double().cpu(), want.double().cpu()
    assert bool(torch.isfinite(y).all())
    err = (y - want).abs()
    assert bool((err <= rtol * float(want.abs().max()) + rtol * want.abs()).all()), \
        float(err.max())


@pytest.mark.parametrize("pair", list(PAIRS))
def test_pair_agrees_with_serial_csr_plain(card, pair):
    mesh, s, x, serial = card
    local, remote = PAIRS[pair]
    op = DistributedOperator.build(s, mesh, local=local, remote=remote)
    assert op.halo == 702 and op.mesh.home.type == "cuda"
    kernels = LAUNCHES[pair]
    before = [k.launches for k in kernels]
    y = op @ x
    torch.cuda.synchronize()
    assert y.device == x.device
    _within(y, serial @ x)
    for k, b in zip(kernels, before):
        assert k.launches - b >= 4, k.__name__  # one launch a part
    for g in op.local_groups + op.remote_groups:
        for p in g.members:
            ran = select_spmv(g.container[p], g.policy(None)).key
            want = DispatchKey(g.key.format, "plain" if g.key.format == "csr" else "cuda")
            assert ran == want, (g.key, p, ran)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_masked_matvec_exact(card, pair):
    mesh, s, x, _ = card
    local, remote = PAIRS[pair]
    op = DistributedOperator.build(s, mesh, local=local, remote=remote)
    sm = SymGS.build(s, device="cuda").distribute(op)
    for c in (0, sm.ncolors - 1):
        mask = sm.masks[c]
        before = dia_spmv.by_shape[(s.shape[0] // 4, True)]
        ym = op.masked_matvec(x, mask)
        want = torch.where(mask, op @ x, torch.zeros((), device=x.device))
        assert torch.equal(ym, want), (pair, c)
        if "dia" in pair:  # the local block, or the rectangular remote window
            assert dia_spmv.by_shape[(s.shape[0] // 4, True)] - before == 4


def test_rowblock_bitwise(card):
    mesh, s, x, serial = card
    chk = DistributedOperator.build(s, mesh, local="csr", mode="rowblock")
    assert torch.equal(chk @ x, serial @ x)


def test_symgs_sweep_agrees_with_serial(card):
    mesh, s, x, serial = card
    sm = SymGS.build(s, device="cuda")
    op = DistributedOperator.build(s, mesh, local=("dia", "cuda"), remote=("coo", "cuda"))
    _within(sm.distribute(op)(x), sm(x))


def test_tuned_partitions_agree(card):
    mesh, s, x, serial = card
    cand = [(f, b) for f in ("csr", "dia", "ell", "coo") for b in ("plain", "cuda")]
    op, table = tune_partitions(s, mesh, candidates=cand)
    assert len(op.choices) == 4 and all((p, "local") in table for p in range(4))
    _within(op @ x, serial @ x)
