"""HPCG's timed solve captured in one CUDA graph, on the card (imports no
JAX: the card's machine has none). HPCG 16^3, depth 3.

  - For the csr/plain pipeline and for one tuned over
    dia/ell/sell/csr/coo x cuda, ``CapturedSolve`` gives the eager
    ``pcg_solve``'s ``x`` and ``rs`` bit for bit (``torch.equal``); two
    replays agree, and a second ``b`` after the capture gives the eager
    result for that ``b``;
  - a warm eager solve under ``torch.cuda.set_sync_debug_mode("error")``
    raises nothing: it reads nothing from the device;
  - ``run_hpcg`` and ``run_hpcg_distributed`` on ``PartMesh.on("cuda",
    parts=4)`` time replays and give ``graph_equal``;
  - a matvec that calls ``.item()`` makes the capture raise, and the solve
    does not run eagerly in its place.

Every test skips without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.apps.hpcg import run_hpcg, run_hpcg_distributed
from repro_torch.core import PartMesh, as_operator, autotune_spmv
from repro_torch.core import matrices as M
from repro_torch.kernels import launch_counts
from repro_torch.solvers import CapturedSolve, build_mg, pcg_solve

pytestmark = pytest.mark.cuda

GRID = 16
DEPTH = 3
ITERS = 20
TUNED = [(fmt, "cuda") for fmt in ("dia", "ell", "sell", "csr", "coo")]


def _pipelines():
    s = M.fdm27(GRID, GRID, GRID)
    ref_A = as_operator(s, "csr", device="cuda").using("plain")
    ref_mg = build_mg(GRID, GRID, GRID, depth=DEPTH, device="cuda")
    opt_A = autotune_spmv(s, candidates=TUNED, device="cuda").operator
    return s, {"csr/plain": (ref_A, ref_mg), "tuned": (opt_A, ref_mg.retuned(TUNED))}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    s, pipes = _pipelines()
    rng = np.random.default_rng(0)
    bs = [torch.from_numpy((s @ np.ones(s.shape[0])).astype(np.float32)).cuda(),
          torch.from_numpy(rng.standard_normal(s.shape[0]).astype(np.float32)).cuda()]
    return pipes, bs


def _solver(A, mg):
    return lambda b: pcg_solve(lambda p: A @ p, b, ITERS, precond=mg)


@pytest.mark.parametrize("pipe", ["csr/plain", "tuned"])
def test_replay_equals_eager_bits(card, pipe):
    pipes, (b0, b1) = card
    fn = _solver(*pipes[pipe])
    solve = CapturedSolve(fn, b0)
    x_e, rs_e = fn(b0)
    x_g, rs_g = solve(b0)
    assert torch.equal(x_g, x_e) and torch.equal(rs_g, rs_e)
    x_g2, rs_g2 = solve(b0)
    assert torch.equal(x_g2, x_g) and torch.equal(rs_g2, rs_g)
    x_e1, rs_e1 = fn(b1)
    x_g1, rs_g1 = solve(b1)
    assert torch.equal(x_g1, x_e1) and torch.equal(rs_g1, rs_e1)
    assert not torch.equal(x_g1, x_g)
    st = solve.stats()
    assert st["nodes"] > 0 and st["capture_s"] > 0 and st["instantiate_s"] > 0
    if pipe == "tuned":
        assert sum(st["launches"].values()) > 0


def test_replays_launch_nothing_from_python(card):
    pipes, (b0, _) = card
    solve = CapturedSolve(_solver(*pipes["tuned"]), b0)
    before = launch_counts()
    for _ in range(3):
        solve(b0)
    torch.cuda.synchronize()
    assert launch_counts() == before


@pytest.mark.parametrize("pipe", ["csr/plain", "tuned"])
def test_warm_eager_solve_reads_nothing(card, pipe):
    pipes, (b0, _) = card
    fn = _solver(*pipes[pipe])
    fn(b0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, rs = fn(b0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(rs))


def test_run_hpcg_times_replays():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    res = run_hpcg(GRID, GRID, GRID, iters=ITERS, depth=DEPTH, reps=2, verbose=False,
                   candidates=TUNED + [("csr", "plain")])
    assert res.graph and res.graph_equal and res.valid and res.bitwise
    assert res.ref_time_s > 0 and res.opt_time_s > 0
    assert res.ref_eager_s > 0 and res.opt_eager_s > 0
    assert set(res.graphs) == {"ref", "opt"}


def test_run_hpcg_distributed_graph_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    res = run_hpcg_distributed(PartMesh.on("cuda", parts=4), GRID, GRID, GRID,
                               iters=ITERS, reps=2, eager_reps=1, verbose=False,
                               tune_levels=True,
                               candidates=[(f, b) for f in ("csr", "dia", "ell", "coo")
                                           for b in ("plain", "cuda")])
    assert res.graph and res.graph_equal and res.valid and res.bitwise


def test_host_read_fails_the_capture_and_nothing_runs_eagerly(card):
    pipes, (b0, _) = card
    A, mg = pipes["csr/plain"]
    calls = []

    def reading(p):
        calls.append(1)
        y = A @ p
        float(y.sum().item())  # a host read: forbidden while the stream captures
        return y

    fn = lambda b: pcg_solve(reading, b, 2, precond=mg)  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA graph"):
        CapturedSolve(fn, b0)
    # the warm-up's two matvecs and the capture's first: nothing ran after it
    assert len(calls) == 3
    torch.cuda.synchronize()
    y = A @ b0  # the card still works, on the caller's stream
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert bool(torch.isfinite(y).all())
