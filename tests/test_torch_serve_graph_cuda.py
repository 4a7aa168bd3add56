"""The serving engine's captured lanes on the card (``-m cuda``; imports no
JAX: the card's machine has none):

  - a healthy tile replays a CUDA graph, and the replays give the eager
    tile's bits for coo/csr/dia/ell/sell, each resident and with a
    column-tile plan, and for bsr through the ``mv`` lane; the graph's
    kernel launches a tile are the eager tile's;
  - evicting a tenant returns ``torch.cuda.memory_allocated`` to within
    1 MiB of its level before the tenant's admission (its graphs die with
    the warm-pool entry);
  - a capture made to fail (a host read inside the lane) resolves its
    tile to ``kind="execution"`` with no eager result, and the next
    healthy tile captures and serves;
  - a flush under an armed kernel fault replays nothing.

Every test skips without a card.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import ExecutionPolicy
from repro_torch.core import matrices as M
from repro_torch.core.health import HealthRegistry
from repro_torch.kernels import launch_counts
from repro_torch.resilience import FaultPlan, FaultSpec
from repro_torch.serve import ServeEngine

tlanes = importlib.import_module("repro_torch.serve.lanes")

pytestmark = pytest.mark.cuda

CUDA_FORMATS = ("coo", "csr", "dia", "ell", "sell")
_N = 96
_S = (M.banded(_N, 3, seed=0) + M.random_uniform(_N, 0.02, seed=1)).tocsr()
_RHS = [np.random.default_rng(10 + i).standard_normal(_N).astype(np.float32)
        for i in range(6)]
WIDTHS = (4, 1, 3, 4, 1, 3)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _policy(tiled):
    return ExecutionPolicy(backends=("cuda",), allow_fallback=False,
                           **({"max_resident_cols": 48} if tiled else {}))


def _engine(dev, graph, fmt="csr", tiled=False, **kw):
    kw.setdefault("max_batch", 4)
    return ServeEngine(fmt=fmt, policy=_policy(tiled), tune_mode=None, device=dev,
                       graph=graph, **kw)


def _serve(eng, rhs, matrix=_S):
    tickets = [eng.submit(matrix, x) for x in rhs]
    eng.flush()
    return tickets


CASES = [(fmt, tiled) for fmt in CUDA_FORMATS for tiled in (False, True)] + [("bsr", False)]


@pytest.mark.parametrize("fmt,tiled", CASES,
                         ids=[f"{f}-{'tiled' if t else 'resident'}" for f, t in CASES])
def test_replays_give_the_eager_bits(cuda, fmt, tiled):
    eng, eager = _engine(cuda, True, fmt, tiled), _engine(cuda, False, fmt, tiled)
    got, want = [], []
    for k in WIDTHS:
        got += _serve(eng, _RHS[:k])
        want += _serve(eager, _RHS[:k])
    for t, w in zip(got, want):
        assert t.ok and w.ok, (t.error, w.error)
        assert t.record.coalesced == w.record.coalesced
        assert torch.equal(t.result(), w.result())
    g = eng.graph_stats()
    coalesced = fmt != "bsr"
    assert g["captures"] == (3 if coalesced else 1) == g["live"]
    assert g["replays"] == (len(WIDTHS) if coalesced else sum(WIDTHS))
    assert g["nodes"] > 0 and eager.graph_stats()["captures"] == 0
    # a replay launches the eager tile's kernels: count one eager tile
    fp = eng.fingerprint(_S)
    lanes = eng.workspace.lanes(fp, eng.workspace._ops[fp])
    lane = lanes[("mm", 4, torch.float32, _policy(tiled))] if coalesced else \
        lanes[("mv", 1, torch.float32, _policy(tiled))]
    before = launch_counts()
    _serve(eager, _RHS[:4] if coalesced else _RHS[:1])
    after = launch_counts()
    assert lane.launches == {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert lane.launches


def test_evicting_a_tenant_returns_its_memory(cuda):
    n = 1 << 16
    big, tiny = M.banded(n, 5, seed=2), M.tridiag(8, seed=3)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    eng = _engine(cuda, True, "dia", capacity=1)
    _serve(eng, [np.ones(8, np.float32)], tiny)  # the engine's own first-use state
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tickets = _serve(eng, xs, big) + _serve(eng, xs[:1], big)
    assert all(t.ok for t in tickets) and eng.graph_stats()["live"] == 2
    held = torch.cuda.memory_allocated() - base
    del tickets
    _serve(eng, [np.ones(8, np.float32)], tiny)  # evicts the big tenant
    torch.cuda.synchronize()
    assert eng.workspace.stats()["evictions"] >= 1 and eng.graph_stats()["live"] == 1
    assert held > 4 * n * 4  # the static inputs alone
    assert abs(torch.cuda.memory_allocated() - base) <= 1 << 20


def test_a_failed_capture_is_an_execution_failure(cuda, monkeypatch):
    real = tlanes.capture

    def reading(fn, device, what):
        # a host read inside the lane: the capture raises
        return real(lambda: (fn(), int(torch.ones(1, device=device).sum()))[0], device, what)

    eng = _engine(cuda, True)
    monkeypatch.setattr(tlanes, "capture", reading)
    tickets = _serve(eng, _RHS[:3]) + _serve(eng, _RHS[:1])
    assert all(not t.ok and t.error.kind == "execution" for t in tickets)
    assert "CUDA graph failed" in str(tickets[0].error)
    assert eng.stats.retries == 0 and eng.stats.batch_splits == 0
    assert eng.graph_stats()["captures"] == 0 and eng.graph_stats()["live"] == 0
    monkeypatch.setattr(tlanes, "capture", real)
    # nothing was left half-captured: a fresh engine captures and serves
    eng = _engine(cuda, True)
    t = _serve(eng, _RHS[:3])
    assert all(x.ok for x in t) and eng.graph_stats()["replays"] == 1


def test_a_chaos_flush_replays_nothing(cuda):
    eng = ServeEngine(fmt="csr", policy=ExecutionPolicy.for_impl("cuda"), tune_mode=None,
                      device=cuda, max_batch=4, health=HealthRegistry(cooldown_s=1e9))
    _serve(eng, _RHS[:4])
    before = eng.graph_stats()
    assert before["replays"] == 1
    with FaultPlan([FaultSpec("kernel", key=("csr", "cuda"), times=3)]) as plan:
        tickets = _serve(eng, _RHS[:4]) + _serve(eng, _RHS[:1])
    assert plan.fired("kernel") >= 1
    assert all(t.ok for t in tickets)
    assert eng.health.quarantined_keys()
    _serve(eng, _RHS[:4])  # quarantined: still eager
    assert eng.graph_stats() == before
