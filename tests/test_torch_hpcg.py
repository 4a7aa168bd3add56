"""The port's solvers and HPCG against the JAX reference on the CPU.

Host-built schedules (greedy colors, multigrid grids) must be equal. The
solvers run f32 sums in another order than XLA, so their results are held
to tolerances: one SymGS sweep and fixed-iteration (P)CG to ``rtol=1e-4``
relative to the vector's norm, the converged 16^3 PCG solution to a
relative 2-norm of 1e-4 (the stopping tolerance is 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.solvers as JS
from repro.core import as_operator as j_as_operator
from repro.core import matrices as M

import repro_torch.solvers as TS
from repro_torch.apps.hpcg import run_hpcg
from repro_torch.core import DispatchKey
from repro_torch.core import as_operator as t_as_operator

SLICE_CANDIDATES = [DispatchKey("csr", "plain"), DispatchKey("csr", "cuda"),
                    DispatchKey("sell", "cuda"), DispatchKey("dia", "plain"),
                    DispatchKey("dia", "cuda")]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("grid", [(5, 4, 3), (8, 8, 8), (16, 16, 16)])
def test_greedy_coloring_equal_reference(grid):
    s = M.fdm27(*grid)
    np.testing.assert_array_equal(TS.greedy_coloring(s), JS.greedy_coloring(s))


@pytest.mark.parametrize("grid", [(4, 4, 4), (8, 8, 8)])
@pytest.mark.parametrize("method", ["multicolor", "reference"])
def test_symgs_sweep_matches_reference(grid, method):
    s = M.fdm27(*grid)
    r = _rhs(s.shape[0])
    x0 = _rhs(s.shape[0], seed=1)
    jg = JS.SymGS.build(s, method=method)
    tg = TS.SymGS.build(s, method=method, device="cpu")
    assert tg.ncolors == jg.ncolors
    want = np.asarray(jg.sweep(jnp.asarray(r), jnp.asarray(x0)))
    got = tg.sweep(torch.from_numpy(r), torch.from_numpy(x0)).numpy()
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_multicolor_symgs_same_on_cuda_backend(fmt):
    """The color sweeps through the cuda registrations (their plain versions
    here) match the plain-backend sweep."""
    s = M.fdm27(8, 8, 8)
    r = torch.from_numpy(_rhs(512))
    plain = TS.SymGS.build(s, device="cpu")
    op = t_as_operator(s, fmt, device="cpu").using("cuda", fallback=False)
    fast = plain.with_operator(op)
    assert _rel(fast(r).numpy(), plain(r).numpy()) < 1e-5


@pytest.mark.parametrize("grid", [(4, 4, 4), (8, 8, 8)])
def test_cg_and_pcg_match_reference(grid):
    s = M.fdm27(*grid)
    n = s.shape[0]
    b = _rhs(n, seed=2)
    jA = j_as_operator(s, "csr").using("plain")
    tA = t_as_operator(s, "csr", device="cpu").using("plain")
    jx, _ = JS.cg_solve(lambda p: jA @ p, jnp.asarray(b), 10)
    tx, _ = TS.cg_solve(lambda p: tA @ p, torch.from_numpy(b), 10)
    assert _rel(tx.numpy(), jx) < 1e-4
    jgs = JS.SymGS.build(s)
    tgs = TS.SymGS.build(s, device="cpu")
    jx, _ = JS.pcg_solve(lambda p: jA @ p, jnp.asarray(b), 8, precond=jgs)
    tx, _ = TS.pcg_solve(lambda p: tA @ p, torch.from_numpy(b), 8, precond=tgs)
    assert _rel(tx.numpy(), jx) < 1e-4
    ji = JS.cg(jA, jnp.asarray(b), tol=1e-6, maxiter=200)
    ti = TS.cg(tA, torch.from_numpy(b), tol=1e-6, maxiter=200)
    assert abs(ti.iters - int(ji.iters)) <= 1
    assert _rel(ti.x.numpy(), ji.x) < 1e-4


def test_build_mg_levels_match_reference():
    jv = JS.build_mg(16, 16, 8, depth=4)
    tv = TS.build_mg(16, 16, 8, depth=4, device="cpu")
    assert [l.grid for l in tv.levels] == [l.grid for l in jv.levels]
    assert tv.describe() == jv.describe()
    for tl, jl in zip(tv.levels, jv.levels):
        assert tl.smoother.ncolors == jl.smoother.ncolors
        assert (tl.R is None) == (jl.R is None)
    assert TS.coarsenable((8, 8, 8)) and not TS.coarsenable((8, 8, 7))


@pytest.fixture(scope="module")
def jax_pcg_16():
    """The reference PCG at 16^3: build_mg + cg on csr/plain (jitted)."""
    s = M.fdm27(16, 16, 16)
    b = jnp.asarray(s @ np.ones(s.shape[0]), jnp.float32)
    A = j_as_operator(s, "csr").using("plain")
    mg = JS.build_mg(16, 16, 16, depth=4)
    info = jax.jit(lambda b: JS.cg(lambda p: A @ p, b, tol=1e-6, maxiter=50,
                                   precond=mg))(b)
    return np.asarray(info.x), int(info.iters)


def test_pcg_16cubed_matches_reference(jax_pcg_16):
    s = M.fdm27(16, 16, 16)
    b = torch.from_numpy((s @ np.ones(s.shape[0])).astype(np.float32))
    A = t_as_operator(s, "csr", device="cpu").using("plain")
    mg = TS.build_mg(16, 16, 16, depth=4, device="cpu")
    info = TS.cg(A, b, tol=1e-6, maxiter=50, precond=mg)
    x_jax, iters_jax = jax_pcg_16
    assert abs(info.iters - iters_jax) <= 1
    assert _rel(info.x.numpy(), x_jax) <= 1e-4


def test_run_hpcg_16cubed_slice(jax_pcg_16):
    """The whole slice on the CPU: the cuda entries run their plain versions.
    It must validate, keep the bitwise tier, and take about the reference's
    iteration count."""
    res = run_hpcg(16, 16, 16, iters=50, timed=False, device="cpu", verbose=False,
                   candidates=SLICE_CANDIDATES)
    assert res.valid and res.bitwise
    assert res.rel_res <= 1e-6
    assert abs(res.pcg_iters - jax_pcg_16[1]) <= 1
    assert set(res.table) == {f"{k.format}/{k.backend}" for k in SLICE_CANDIDATES}
    assert len(res.mg_levels.split("|")) == 4


def test_run_hpcg_unpreconditioned_and_guards():
    res = run_hpcg(6, 6, 6, iters=60, timed=True, reps=1, device="cpu", verbose=False,
                   precond=False, candidates=[("csr", "plain"), ("dia", "cuda")])
    assert res.bitwise and res.valid and res.ref_time_s > 0
    with pytest.raises(NotImplementedError, match="select"):
        run_hpcg(4, 4, 4, device="cpu", tune_mode="predict")
