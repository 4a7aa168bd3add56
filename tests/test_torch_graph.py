"""The captured timed solve's host side, and what it changed in the plain
kernels, on the CPU against the JAX reference.

  - ``CapturedSolve`` and ``run_hpcg(graph=True)`` refuse a host device and
    run nothing eagerly in the graph's place; a mesh over several devices
    is refused the same way;
  - ``run_hpcg(..., device="cpu", graph=False)`` times the eager loop and
    gives the reference's ``pcg_iters`` (within one, as
    ``tests/test_torch_hpcg.py`` holds it), ``valid`` and ``bitwise``;
  - plain COO keeps its entries in row order, with their segment bounds, on
    the container: the order is read once a container, the sums are the
    uncached path's bits on sorted and unsorted arrays, and they agree with
    the reference's ``coo/plain`` at rtol 2e-4 (another summation order);
  - csr/plain and sell/plain check their segments on the first call for a
    container and not after, with the same bits, and csr/plain agrees with
    the reference's at 8^3 at rtol 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as J
from repro.apps.hpcg import run_hpcg as j_run_hpcg
from repro.core import matrices as M

import repro_torch.core as T
from repro_torch.apps.hpcg import run_hpcg, run_hpcg_distributed
from repro_torch.core import PartMesh
from repro_torch.core.formats import COO
from repro_torch.core.spmv import coo_spmv_plain, csr_spmv_plain, sell_spmv_plain
from repro_torch.solvers import CapturedSolve, pcg_solve

CANDIDATES = [("csr", "plain"), ("dia", "plain"), ("ell", "plain")]


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_captured_solve_refuses_the_host_and_runs_nothing():
    calls = []

    def solve(b):
        calls.append(b)
        return b, torch.dot(b, b)

    with pytest.raises(ValueError, match="CUDA device"):
        CapturedSolve(solve, torch.ones(8))
    assert calls == []


def test_run_hpcg_graph_on_the_host_raises_before_any_phase(monkeypatch):
    import repro_torch.apps.hpcg as thpcg

    def no_setup(*a, **kw):
        raise AssertionError("a phase ran")

    monkeypatch.setattr(thpcg.M, "fdm27", no_setup)
    with pytest.raises(ValueError, match="graph=False"):
        run_hpcg(4, 4, 4, device="cpu", verbose=False, graph=True)
    with pytest.raises(ValueError, match="graph=False"):
        run_hpcg_distributed(PartMesh.on("cpu", parts=2), 4, 4, 4, verbose=False, graph=True)


def test_graph_on_several_devices_raises():
    """A mesh over two cards is refused before any phase (the check
    ``run_hpcg_distributed`` makes on its mesh's devices; no card here to
    build such a mesh)."""
    from repro_torch.apps.hpcg import _check_graph

    two = (torch.device("cuda", 0), torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="across cards"):
        _check_graph(True, two)
    _check_graph(True, two[:2])
    _check_graph(False, two)
    with pytest.raises(ValueError, match="graph=False"):  # the tolerance solves too
        _check_graph(True, (torch.device("cpu"),))


@pytest.mark.parametrize("timed", [False, True])
def test_run_hpcg_eager_on_the_host_matches_reference(timed):
    """``graph=False`` on the host: the eager loop is the timed solve, and
    the run's checks agree with the reference's."""
    res = run_hpcg(16, 16, 16, iters=50, reps=1, device="cpu", verbose=False,
                   candidates=CANDIDATES, graph=False, timed=timed)
    want = j_run_hpcg(16, 16, 16, iters=50, timed=False, verbose=False,
                      candidates=CANDIDATES)
    assert res.valid == want.valid and res.bitwise == want.bitwise
    assert res.valid and res.bitwise and res.rel_res <= 1e-6
    assert abs(res.pcg_iters - int(want.pcg_iters)) <= 1
    assert not res.graph and not res.graph_equal and res.graphs == {}
    assert res.ref_eager_s == res.ref_time_s and res.opt_eager_s == res.opt_time_s
    assert (res.ref_time_s > 0 and res.opt_time_s > 0) == timed


def _coo_arrays(s, order):
    c = s.tocoo()
    idx = np.arange(c.nnz) if order is None else order(c.nnz)
    return (c.row[idx].astype(np.int32), c.col[idx].astype(np.int32),
            c.data[idx].astype(np.float32))


def _uncached_coo(row, col, val, x, nrows):
    """The plain COO SpMV as it was before its rows were cached."""
    from repro_torch.kernels.coo_spmv import row_sorted

    row, col, val, _ = row_sorted(row, col, val)
    prod = val * x[col.long()]
    bounds = torch.arange(nrows + 1, dtype=row.dtype, device=row.device)
    return torch.segment_reduce(prod, "sum", offsets=torch.searchsorted(row, bounds))


ORDERS = {"sorted": None,
          "reversed": lambda n: np.arange(n)[::-1].copy(),
          "shuffled": lambda n: np.random.default_rng(3).permutation(n)}


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("grid", [(4, 4, 4), (8, 6, 5)])
def test_plain_coo_cached_rows(order, grid, monkeypatch):
    import repro_torch.kernels.coo_spmv as kcoo

    s = M.fdm27(*grid).tocsr()
    n = s.shape[0]
    row, col, val = _coo_arrays(s, ORDERS[order])
    A = COO(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(val), s.shape)
    reads = []
    real = kcoo.row_sorted
    monkeypatch.setattr(kcoo, "row_sorted", lambda *a: reads.append(1) or real(*a))
    xs = [torch.from_numpy(_rhs(n, seed)) for seed in range(3)]
    got = [coo_spmv_plain(A, x) for x in xs]
    assert len(reads) == 1, "the row order is read once a container"
    for x, y in zip(xs, got):
        want = _uncached_coo(A.row, A.col, A.val, x, n)
        assert torch.equal(y, want)
        ja = J.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(val), s.shape)
        ref = np.asarray(J.spmv(ja, jnp.asarray(x.numpy()), impl="plain"))
        np.testing.assert_allclose(y.numpy(), ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())


def test_plain_coo_sentinels_past_the_last_row():
    """Pad entries (row = nrows) lie past the last segment and add nothing."""
    s = M.fdm27(4, 4, 4).tocsr()
    n = s.shape[0]
    row, col, val = _coo_arrays(s, ORDERS["shuffled"])
    pad = 5
    row = np.concatenate([row, np.full(pad, n, np.int32)])
    col = np.concatenate([col, np.zeros(pad, np.int32)])
    val = np.concatenate([val, np.ones(pad, np.float32)])
    A = COO(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(val), s.shape)
    x = torch.from_numpy(_rhs(n))
    y = coo_spmv_plain(A, x)
    assert torch.equal(y, _uncached_coo(A.row, A.col, A.val, x, n))
    np.testing.assert_allclose(y.numpy(), s @ x.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fmt", ["csr", "sell"])
def test_plain_segments_checked_once_same_bits(fmt, monkeypatch):
    """The first call for a container runs ``segment_reduce`` checked, the
    later ones unchecked; every call gives the checked call's bits."""
    s = M.fdm27(8, 8, 8)
    n = s.shape[0]
    A = T.as_operator(s, fmt, device="cpu").container
    unsafe = []
    real = torch.segment_reduce
    monkeypatch.setattr(torch, "segment_reduce",
                        lambda *a, **kw: unsafe.append(kw["unsafe"]) or real(*a, **kw))
    fn = {"csr": csr_spmv_plain, "sell": sell_spmv_plain}[fmt]
    x = torch.from_numpy(_rhs(n))
    ys = [fn(A, x) for _ in range(3)]
    assert unsafe == [False, True, True]
    assert all(torch.equal(y, ys[0]) for y in ys)
    if fmt == "csr":
        ref = np.asarray(J.spmv(J.as_operator(s, "csr").container, jnp.asarray(x.numpy()),
                                impl="plain"))
        np.testing.assert_allclose(ys[0].numpy(), ref, rtol=2e-4,
                                   atol=2e-4 * np.abs(ref).max())


def test_plain_coo_spmv_in_a_vcycle_keeps_bits():
    """A fixed-iteration PCG whose R/P are plain COO: two solves, the second
    on warm caches, give equal bits."""
    from repro_torch.solvers import build_mg

    s = M.fdm27(8, 8, 8)
    A = T.as_operator(s, "csr", device="cpu").using("plain")
    mg = build_mg(8, 8, 8, depth=2, device="cpu")
    b = torch.from_numpy(_rhs(s.shape[0]))
    x1, rs1 = pcg_solve(lambda p: A @ p, b, 10, precond=mg)
    x2, rs2 = pcg_solve(lambda p: A @ p, b, 10, precond=mg)
    assert torch.equal(x1, x2) and torch.equal(rs1, rs2)
    assert all("plain_rows" in lvl.R.container.cache for lvl in mg.levels[:-1])


def test_sparse_coo_plain_matches_scipy_on_random_unsorted():
    rng = np.random.default_rng(7)
    s = sp.random(300, 200, density=0.05, random_state=rng, format="coo", dtype=np.float32)
    perm = rng.permutation(s.nnz)
    A = COO(torch.from_numpy(s.row[perm].astype(np.int32)),
            torch.from_numpy(s.col[perm].astype(np.int32)),
            torch.from_numpy(s.data[perm]), s.shape)
    x = rng.standard_normal(200).astype(np.float32)
    y = coo_spmv_plain(A, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, s @ x, rtol=1e-5, atol=1e-5)
