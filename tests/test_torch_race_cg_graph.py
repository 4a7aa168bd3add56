"""The SpMV path's last compiled programs, on the CPU against the JAX
reference: the tuner's race on captured calls, the tolerance CG with its
stop on the device, and the workspace's compiled SpMV.

  - ``cg_chunk`` run eagerly from ``cg_start`` gives ``cg``'s ``x``, ``r``,
    ``rel_res`` and iterations bit for bit at chunk 1, 3, 7, ``maxiter``
    and ``maxiter + 5``: early convergence, reaching ``maxiter``, ``b = 0``
    (no iteration), a matvec that returns NaN at its third call (the eager
    ``k``, a non-finite ``rel_res``) and 8^3 with the V-cycle;
  - against the reference's ``repro.solvers.cg.cg``, ``k`` is within one
    and ``x`` within rtol 2e-4;
  - ``CapturedCG``, ``autotune_spmv(graph=True)`` and ``run_hpcg(graph=True,
    timed=False)`` refuse the host and run nothing;
  - with the capture stubbed on host tensors (a stand-in graph that runs
    the captured function again, captured under a mode that fails on any
    host read), ``CapturedCG`` gives ``cg``'s bits, replays its chunk
    ``ceil(k / chunk)`` times and reads nothing from the device inside
    either graph; the race captures every candidate, holds each replay to
    the eager bits, and lists a failed capture as ``error: CaptureError``;
  - ``autotune_spmv(graph=None, device="cpu")`` races eagerly, with
    ``graph=False``'s keys and skip reasons, and the workspace's host
    ``spmv`` is dispatch's eager call, within rtol 2e-4 of the reference's.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core as J
import repro.solvers as JS
from repro.core import matrices as M

import repro_torch.core as T
from repro_torch.apps.hpcg import run_hpcg, run_hpcg_distributed
from repro_torch.capture import CaptureError, Captured
from repro_torch.core import PartMesh, SpmvWorkspace, as_operator, autotune_spmv
from repro_torch.solvers import (
    CapturedCG, build_mg, cg, cg_chunk, cg_start, pdot, pnorm,
)

tcapture = importlib.import_module("repro_torch.capture")
tcg = importlib.import_module("repro_torch.solvers.cg")
ttune = importlib.import_module("repro_torch.core.autotune")

READS = {"_local_scalar_dense", "nonzero", "unique", "_unique", "_unique2", "unique_dim",
         "unique_consecutive", "item"}
TOL = 1e-6


def _problem(g: int):
    s = M.fdm27(g, g, g)
    return s, torch.from_numpy((s @ np.ones(s.shape[0])).astype(np.float32))


class _NaNAt:
    """``A @ p``, except that call ``at`` returns NaNs."""

    def __init__(self, A, at: int):
        self.A, self.at, self.calls = A, at, 0

    def __call__(self, p):
        self.calls += 1
        y = self.A @ p
        return torch.full_like(y, float("nan")) if self.calls == self.at else y


def _case(name: str):
    """(matvec factory, b, maxiter, precond) for each case."""
    if name == "vcycle_8":
        s, b = _problem(8)
        A = as_operator(s, "csr", device="cpu").using("plain")
        return (lambda: A), b, 8, build_mg(8, 8, 8, depth=2, fmt="csr", device="cpu")
    s, b = _problem(5)
    A = as_operator(s, "csr", device="cpu").using("plain")
    if name == "converges":
        return (lambda: A), b, 200, None
    if name == "maxiter":
        return (lambda: A), b, 4, None
    if name == "zero_b":
        return (lambda: A), torch.zeros_like(b), 50, None
    return (lambda: _NaNAt(A, 3)), b, 50, None


def _eager_state(A, b, maxiter, precond):
    """``cg``'s loop, step for step, keeping ``r`` (which ``cg`` drops)."""
    M_ = precond if precond is not None else (lambda r: r)
    bnorm = torch.clamp(pnorm(b), min=1e-30)
    z0 = M_(b)
    x, r, p, rz, k = torch.zeros_like(b), b, z0, pdot(b, z0), 0
    while k < maxiter:
        rn = pnorm(r)
        if not bool(torch.isfinite(rn) & (rn > TOL * bnorm)):
            break
        Ap = A(p) if callable(A) else A @ p
        alpha = rz / torch.clamp(pdot(p, Ap), min=1e-30)
        x = alpha * p + x
        r = -alpha * Ap + r
        z = M_(r)
        rz_new = pdot(r, z)
        p = rz_new / torch.clamp(rz, min=1e-30) * p + z
        rz = rz_new
        k += 1
    return x, r, k


def _chunked(A, b, maxiter, precond, chunk):
    state, bnorm = cg_start(b, tol=TOL, maxiter=maxiter, precond=precond)
    replays = 0
    while bool(state.active):
        state = cg_chunk(state, A, bnorm=bnorm, tol=TOL, maxiter=maxiter, precond=precond,
                         chunk=chunk)
        replays += 1
    return state, bnorm, replays


def _same(a, b) -> bool:
    """Equal bits (NaNs included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


CASES = ("converges", "maxiter", "zero_b", "nan_at_3", "vcycle_8")


@pytest.mark.parametrize("chunk", ["1", "3", "7", "maxiter", "maxiter+5"])
@pytest.mark.parametrize("case", CASES)
def test_cg_chunk_gives_cg_bits(case, chunk):
    make, b, maxiter, mg = _case(case)
    chunk = {"maxiter": maxiter, "maxiter+5": maxiter + 5}.get(chunk) or int(chunk)
    want = cg(make(), b, tol=TOL, maxiter=maxiter, precond=mg)
    x_e, r_e, k_e = _eager_state(make(), b, maxiter, mg)
    assert _same(x_e, want.x) and k_e == want.iters
    state, bnorm, replays = _chunked(make(), b, maxiter, mg, chunk)
    assert int(state.k) == want.iters
    assert _same(state.x, want.x) and _same(state.r, r_e)
    rel = pnorm(state.r) / bnorm
    assert _same(rel, want.rel_res)
    assert replays == math.ceil(want.iters / chunk)
    if case == "zero_b":
        assert want.iters == 0 and replays == 0 and float(rel) == 0.0
    if case == "maxiter":
        assert want.iters == maxiter and float(rel) > TOL
    if case == "nan_at_3":
        assert want.iters == 3 and not math.isfinite(float(rel))
    if case in ("converges", "vcycle_8"):
        assert 0 < want.iters < maxiter and float(rel) <= TOL


@pytest.fixture(scope="module")
def reference_8():
    """The reference's tolerance CG at 8^3 on csr/plain, unpreconditioned
    and with its V-cycle."""
    s, b = _problem(8)
    A = J.as_operator(s, "csr").using("plain")
    bj = jnp.asarray(b.numpy())
    out = {}
    for name, mg in (("none", None), ("vcycle", JS.build_mg(8, 8, 8, depth=2))):
        info = JS.cg(lambda p: A @ p, bj, tol=TOL, maxiter=50, precond=mg)
        out[name] = (np.asarray(info.x), int(info.iters))
    return out


@pytest.mark.parametrize("chunk", [1, 3, 7])
@pytest.mark.parametrize("precond", ["none", "vcycle"])
def test_cg_chunk_against_reference(reference_8, precond, chunk):
    s, b = _problem(8)
    A = as_operator(s, "csr", device="cpu").using("plain")
    mg = build_mg(8, 8, 8, depth=2, fmt="csr", device="cpu") if precond == "vcycle" else None
    state, _, _ = _chunked(A, b, 50, mg, chunk)
    x_want, k_want = reference_8[precond]
    assert abs(int(state.k) - k_want) <= 1
    np.testing.assert_allclose(state.x.numpy(), x_want, rtol=2e-4, atol=2e-4 * np.abs(x_want).max())


def test_captured_graphs_refuse_the_host_and_run_nothing(monkeypatch):
    calls = []

    def matvec(p):
        calls.append(p)
        return p

    with pytest.raises(ValueError, match="CUDA device"):
        CapturedCG(matvec, torch.ones(8), tol=TOL, maxiter=5)

    def no_conversion(*a, **kw):
        raise AssertionError("a candidate was converted")

    monkeypatch.setattr(ttune, "_from_dense", no_conversion)
    monkeypatch.setattr(ttune, "_container_to_scipy", no_conversion)
    with pytest.raises(ValueError, match="graph=False"):
        autotune_spmv(M.fdm27(4, 4, 4), device="cpu", graph=True)
    assert calls == []


def test_run_hpcg_graph_raises_on_the_host_untimed(monkeypatch):
    import repro_torch.apps.hpcg as thpcg

    def no_setup(*a, **kw):
        raise AssertionError("a phase ran")

    monkeypatch.setattr(thpcg.M, "fdm27", no_setup)
    with pytest.raises(ValueError, match="graph=False"):
        run_hpcg(4, 4, 4, device="cpu", verbose=False, timed=False, graph=True)
    with pytest.raises(ValueError, match="graph=False"):
        run_hpcg_distributed(PartMesh.on("cpu", parts=2), 4, 4, 4, verbose=False,
                             timed=False, graph=True)


# -------------------------------------------------- the capture, stubbed --


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in READS:
            raise AssertionError(f"the captured work read the device: {func}")
        return func(*args, **(kwargs or {}))


class _Replay:
    """A graph's stand-in: a replay runs the function again into its output
    (``bias`` is added to a tensor output, to plant a replay that differs)."""

    def __init__(self, fn, out, bias=0.0):
        self.fn, self.out, self.bias = fn, out, bias

    def replay(self):
        with torch.no_grad():
            y = self.fn()
            if isinstance(self.out, torch.Tensor):
                self.out.copy_(y + self.bias)

    def reset(self):
        self.fn = self.out = None


class CaptureStub:
    """``capture`` on the host: warms up, captures under ``_NoHostRead``, or
    raises ``fail`` for the work whose name holds ``fail_on``."""

    def __init__(self):
        self.calls, self.fail_on, self.bias = [], None, 0.0

    def __call__(self, fn, device, what, keep_warm=False):
        self.calls.append(what)
        if self.fail_on is not None and self.fail_on in what:
            raise CaptureError(f"capturing {what} in a CUDA graph failed: planted")
        with torch.no_grad():
            warm = fn()
            if isinstance(warm, torch.Tensor):
                warm = warm.clone()
            with _NoHostRead():
                out = fn()
        return Captured(_Replay(fn, out, self.bias), out, 0.0, 0.0, 1, {},
                        warm if keep_warm else None)


@pytest.fixture
def stub(monkeypatch):
    s = CaptureStub()
    monkeypatch.setattr(tcapture, "capture", s)
    monkeypatch.setattr(tcg, "_on_card", lambda b: True)
    monkeypatch.setattr(ttune, "_capturable", lambda dev: True)
    return s


@pytest.mark.parametrize("chunk", ["1", "3", "maxiter+5"])
@pytest.mark.parametrize("case", ["converges", "zero_b", "vcycle_8"])
def test_captured_cg_stubbed_gives_cg_bits(stub, case, chunk):
    make, b, maxiter, mg = _case(case)
    chunk = maxiter + 5 if chunk == "maxiter+5" else int(chunk)
    want = cg(make(), b, tol=TOL, maxiter=maxiter, precond=mg)
    solver = CapturedCG(make(), b, tol=TOL, maxiter=maxiter, precond=mg, chunk=chunk)
    assert stub.calls == ["the tolerance CG's setup", f"the tolerance CG's chunk of {chunk}"]
    for _ in range(2):  # a second call replays the same graphs
        got = solver(b)
        assert got.iters == want.iters and torch.equal(got.x, want.x)
        assert torch.equal(got.rel_res, want.rel_res)
        st = solver.stats()
        assert st["replays"] == math.ceil(want.iters / chunk)
        assert st["computed"] == st["replays"] * chunk and st["iters"] == want.iters
    got.x.zero_()  # the result is a copy, not the static buffer
    assert torch.equal(solver(b).x, want.x)
    with pytest.raises(ValueError, match="captured for b"):
        solver(b[:-1])


def test_race_stubbed_captures_every_candidate(stub):
    cand = [("csr", "plain"), ("dia", "plain"), ("ell", "plain"), ("coo", "plain"),
            ("sell", "plain"), ("bsr", "plain"), ("csr", "cuda"), ("dia", "cuda")]
    eager = autotune_spmv(M.fdm27(4, 4, 4), candidates=cand, device="cpu", iters=2,
                          warmup=1, graph=False)
    res = autotune_spmv(M.fdm27(4, 4, 4), candidates=cand, device="cpu", iters=2, warmup=1)
    assert res.graph and not eager.graph
    assert set(res.table) == set(eager.table) and res.skipped == eager.skipped
    assert res.replay_equal == len(res.table) == len(stub.calls)
    stub.fail_on = "dia/cuda"
    res = autotune_spmv(M.fdm27(4, 4, 4), candidates=cand, device="cpu", iters=1, warmup=0)
    assert ("dia", "cuda", "error: CaptureError") in res.skipped
    assert ("dia", "cuda") not in res.table and res.replay_equal == len(res.table)


def test_race_stubbed_replay_that_differs_raises(stub):
    stub.bias = 1.0
    with pytest.raises(RuntimeError, match="differs from the eager call"):
        autotune_spmv(M.fdm27(4, 4, 4), candidates=[("csr", "plain")], device="cpu",
                      iters=1, warmup=0)


def test_race_stubbed_time_fn_gets_the_replay(stub):
    seen = []

    def time_fn(fn, A, x, key, iters, warmup):
        seen.append(fn(A, x).clone())
        with pytest.raises(ValueError, match="other tensors"):
            fn(A, x.clone())
        return 1.0

    res = autotune_spmv(M.fdm27(4, 4, 4), candidates=[("csr", "plain")], device="cpu",
                        time_fn=time_fn)
    A = as_operator(M.fdm27(4, 4, 4), "csr", device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(64).astype(np.float32))
    assert res.table == {("csr", "plain"): 1.0} and torch.equal(seen[0], A.using("plain") @ x)


# ------------------------------------------------------------ the host --


def test_race_on_the_host_is_eager_with_todays_keys():
    cand = [("csr", "plain"), ("dia", "plain"), ("ell", "cuda"), ("bsr", "plain"),
            ("coo", "cuda"), ("dense", "dense")]
    got = autotune_spmv(M.fdm27(4, 4, 4), candidates=cand, device="cpu", iters=1, warmup=0)
    eager = autotune_spmv(M.fdm27(4, 4, 4), candidates=cand, device="cpu", iters=1, warmup=0,
                          graph=False)
    assert not got.graph and got.capture_s == 0.0 and got.replay_equal == 0
    assert set(got.table) == set(eager.table) and got.skipped == eager.skipped
    want = J.autotune_spmv(M.fdm27(4, 4, 4), iters=1, warmup=0,
                           candidates=[(f, "pallas" if i == "cuda" else i) for f, i in cand])
    spelled = {(f, "cuda" if i == "pallas" else i) for f, i in want.table}
    assert set(got.table) == spelled


def test_workspace_host_spmv_is_dispatch_eager():
    s = (M.banded(64, 3, seed=0) + M.random_uniform(64, 0.05, seed=1)).tocsr()
    x = np.random.default_rng(2).standard_normal(64).astype(np.float32)
    ws = SpmvWorkspace(max_entries=2)
    for fmt, impl in (("csr", "plain"), ("dia", "cuda"), ("ell", "plain")):
        y1 = ws.spmv(s, x, fmt, impl, device="cpu")
        y2 = ws.spmv(s, x, fmt, impl, device="cpu")
        op = as_operator(s, fmt, device="cpu")
        want = T.spmv(op.container, torch.from_numpy(x), policy=T.policy_for_impl(impl))
        assert torch.equal(y1, want) and torch.equal(y2, want) and y1 is not y2
        ref = J.SpmvWorkspace().spmv(s, x, fmt, "pallas" if impl == "cuda" else impl)
        np.testing.assert_allclose(y1.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)
    assert ws.live_lanes() == 0 and ws.stats()["hits"] == 3
