"""The tuner's captured race, the tolerance CG as CUDA graphs and the
workspace's captured SpMV, on the card (imports no JAX: the card's machine
has none).

  - every race key at 16^3 (six formats x plain/cuda, and dense) gives its
    eager call's bits on the graph's replay, and a race over them lists no
    error and counts every timed key replay-equal;
  - ``CapturedCG`` gives the eager ``cg``'s ``x`` bits and iterations at
    16^3 and 32^3, csr/plain and a dia/cuda operator, each under its
    V-cycle, for every chunk tested, and replays its chunk ``ceil(k /
    chunk)`` times; a matvec that reads the host makes its capture raise;
  - ``run_hpcg(graph=True)`` at 16^3 gives ``graph=False``'s ``pcg_iters``,
    solution (``rel_err``) and ``valid``, and each captured tolerance solve
    the eager one's bits;
  - the workspace's captured lane lives beside its entry and goes with it
    on eviction, and a second call leaves the first call's result intact.

Every test skips without a card.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.apps.hpcg import run_hpcg
from repro_torch.capture import CaptureError
from repro_torch.core import SpmvWorkspace, as_operator, autotune_spmv, from_dense, spmv
from repro_torch.core import matrices as M
from repro_torch.core.autotune import DEFAULT_CANDIDATES, _CapturedCall, _same_bits
from repro_torch.core.operator import DEFAULT_POLICY
from repro_torch.solvers import CapturedCG, build_mg, cg

pytestmark = pytest.mark.cuda

KEYS = [(k.format, k.backend) for k in DEFAULT_CANDIDATES]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rhs(s):
    return torch.from_numpy((s @ np.ones(s.shape[0])).astype(np.float32)).cuda()


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]}/{k[1]}")
def test_race_key_replay_equals_eager(card, key):
    fmt, impl = key
    s = M.fdm27(16, 16, 16)
    A = from_dense(s, fmt, device="cuda")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(s.shape[1])
                         .astype(np.float32)).cuda()
    pol = DEFAULT_POLICY.preferring(impl)
    want = spmv(A, x, policy=pol)
    call = _CapturedCall(A, x, pol, f"{fmt}/{impl}")
    try:
        assert _same_bits(call(A, x), want) and _same_bits(call(A, x), want)
        call.check()
    finally:
        call.free()


def test_race_is_captured_with_no_error(card):
    res = autotune_spmv(M.fdm27(16, 16, 16), candidates=KEYS, device="cuda")
    assert res.graph and res.capture_s > 0 and res.instantiate_s > 0
    assert not [sk for sk in res.skipped if sk[2].startswith("error:")], res.skipped
    assert res.replay_equal == len(res.table) >= 11
    eager = autotune_spmv(M.fdm27(16, 16, 16), candidates=KEYS, device="cuda", graph=False)
    assert not eager.graph and set(eager.table) == set(res.table)
    assert eager.skipped == res.skipped


def _solvers(g):
    s = M.fdm27(g, g, g)
    plain = as_operator(s, "csr", device="cuda").using("plain")
    mg = build_mg(g, g, g, depth=3, device="cuda")
    dia = as_operator(s, "dia", device="cuda").using("cuda")
    return s, {"csr/plain": (plain, mg), "dia/cuda": (dia, mg.retuned([("dia", "cuda")]))}


@pytest.mark.parametrize("chunk", [1, 2, 5, 50])
@pytest.mark.parametrize("g", [16, 32])
def test_captured_cg_equals_cg(card, g, chunk):
    s, pipes = _solvers(g)
    b = _rhs(s)
    for name, (A, mg) in pipes.items():
        want = cg(A, b, tol=1e-6, maxiter=50, precond=mg)
        solver = CapturedCG(A, b, tol=1e-6, maxiter=50, precond=mg, chunk=chunk)
        got = solver(b)
        assert got.iters == want.iters, name
        assert torch.equal(got.x, want.x) and torch.equal(got.rel_res, want.rel_res), name
        st = solver.stats()
        assert st["replays"] == math.ceil(want.iters / chunk)
        assert st["computed"] == st["replays"] * chunk and st["nodes"] > 0
        again = solver(b)  # the first result is a copy the replays leave alone
        assert torch.equal(again.x, got.x) and again.x.data_ptr() != got.x.data_ptr()


def test_captured_cg_host_read_raises(card):
    s, pipes = _solvers(16)
    A, mg = pipes["csr/plain"]

    def reads(p):
        y = A @ p
        return y * float(y.sum().item() != 0.0)

    with pytest.raises(CaptureError, match="tolerance CG"):
        CapturedCG(reads, _rhs(s), tol=1e-6, maxiter=50, precond=mg)
    torch.randn(4, device="cuda")  # the device's generator still draws


def test_run_hpcg_graph_matches_eager(card):
    kw = dict(iters=50, depth=3, timed=False, verbose=False, candidates=[("dia", "cuda")])
    got = run_hpcg(16, 16, 16, graph=True, conv_eager=("ref", "chk", "opt"), **kw)
    want = run_hpcg(16, 16, 16, graph=False, **kw)  # one key: the same picks
    assert got.valid and got.bitwise and got.valid == want.valid
    assert got.pcg_iters == want.pcg_iters and got.rel_err == want.rel_err
    assert got.rel_res == want.rel_res and want.conv_graphs == {}
    assert set(got.conv_graphs) == {"ref", "chk", "opt"}
    for name, st in got.conv_graphs.items():
        assert st["equal"], name
        assert st["replays"] == math.ceil(st["iters"] / st["chunk"])


def test_workspace_lane_lives_with_its_entry(card):
    s1 = M.fdm27(8, 8, 8)
    s2 = M.banded(512, 3, seed=0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(512).astype(np.float32))
    ws = SpmvWorkspace(max_entries=1)
    y1 = ws.spmv(s1, x, "dia", "cuda")
    want = as_operator(s1, "dia", device="cuda").using("cuda") @ x.cuda()
    assert ws.live_lanes() == 1 and torch.equal(y1, want)
    y1_copy = y1.clone()
    y2 = ws.spmv(s1, 2 * x, "dia", "cuda")  # a replay of the same lane
    assert ws.live_lanes() == 1 and torch.equal(y1, y1_copy) and not torch.equal(y1, y2)
    ws.spmv(s2, x, "dia", "cuda")  # evicts s1's entry and its lane
    assert ws.stats()["evictions"] == 1 and ws.live_lanes() == 1
    ws.discard(ws.keys()[0])
    assert ws.live_lanes() == 0 and torch.equal(y1, y1_copy)
