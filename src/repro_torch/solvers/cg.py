"""Conjugate-Gradient solvers over ``SparseOperator`` matvecs.

The PyTorch counterpart of ``repro.solvers.cg``:

  - ``cg_solve``  : fixed-iteration CG — the timed HPCG phases use it, so
    every format/backend executes the same op mix;
  - ``pcg_solve`` : fixed-iteration preconditioned CG;
  - ``cg``        : residual-tolerance stopping, preconditioned or not —
    HPCG's "50 iterations to 1e-6" criterion.

JAX's ``fori_loop``/``while_loop`` become Python loops: PyTorch runs
eagerly, so ``cg`` reads the residual norm on the host once per iteration
to decide whether to stop. Every reduction is deterministic (``torch.dot``,
``vector_norm``), so two runs of the same solve agree bit for bit.

The reference compiles its fixed-iteration solve with ``jax.jit`` into one
program; :class:`CapturedSolve` is the port's form of that: the whole solve
captured once in a CUDA graph and replayed as one launch.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


def as_matvec(A) -> Callable:
    """``lambda p: A @ p`` for an operator, or ``A`` itself when callable."""
    return A if callable(A) else (lambda p: A @ p)


def pdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dot product ``<x, y>`` (HPCG's ``ComputeDotProduct``)."""
    return torch.dot(x, y)


def pnorm(x: torch.Tensor) -> torch.Tensor:
    """2-norm ``||x||``."""
    return torch.linalg.vector_norm(x)


def axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a*x + y`` (HPCG's ``ComputeWAXPBY``)."""
    return a * x + y


def _floor(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, min=1e-30)


def cg_solve(spmv_fn: Callable, b: torch.Tensor, iters: int):
    """Fixed-iteration CG (no preconditioner). Returns ``(x, rs)``, the
    final iterate and squared residual norm."""
    x, r, p, rs = torch.zeros_like(b), b, b, pdot(b, b)
    for _ in range(iters):
        Ap = spmv_fn(p)
        alpha = rs / _floor(pdot(p, Ap))
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        rs_new = pdot(r, r)
        p = axpy(rs_new / _floor(rs), p, r)
        rs = rs_new
    return x, rs


def pcg_solve(spmv_fn: Callable, b: torch.Tensor, iters: int,
              precond: Optional[Callable] = None):
    """Fixed-iteration preconditioned CG (``precond`` an SPD map
    ``r -> M^-1 r``). Returns ``(x, rs)``."""
    M = precond if precond is not None else (lambda r: r)
    z0 = M(b)
    x, r, p, rz = torch.zeros_like(b), b, z0, pdot(b, z0)
    for _ in range(iters):
        Ap = spmv_fn(p)
        alpha = rz / _floor(pdot(p, Ap))
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = M(r)
        rz_new = pdot(r, z)
        p = axpy(rz_new / _floor(rz), p, z)
        rz = rz_new
    return x, pdot(r, r)


class CapturedSolve:
    """A fixed-iteration solve ``fn(b) -> (x, rs)`` captured in one CUDA
    graph: the counterpart of the reference's ``jax.jit(lambda b:
    pcg_solve(...))``, whose ``fori_loop``, V-cycle and color sweeps are
    one compiled program.

    Construction goes through :func:`repro_torch.capture.capture`: ``fn``
    runs once eagerly on a side stream (the warm-up, where every
    first-call cache is built and the host may read the device: the
    kernel library, the checked containers, row lists, tile indices, work
    lists, sorted COO rows), then one more call is captured with a static
    ``b``, ``x`` and ``rs``, and instantiated. A host read inside ``fn``
    makes the capture raise; nothing runs eagerly in its place. A call
    copies ``b`` into the static input, replays the graph and returns
    clones of ``x`` and ``rs``: the graph holds the eager solve's kernels in
    its order, so a replay gives the eager solve's bits.

    Python runs only at the warm-up and the capture: launch counters and
    the health registry count those two, never a replay.

    Attributes:
        capture_s: seconds of the capture (``fn``'s Python run included).
        instantiate_s: seconds of ``cudaGraphInstantiate``.
        nodes: the graph's node count (kernels, copies, memsets).
        launches: each kernel wrapper's launches during the capture, the
            graph's hand-written kernel launches a solve.

    Raises:
        ValueError: ``b`` is not on a CUDA device (the eager loop is the
            caller's choice, never a stand-in).
        RuntimeError: the capture failed (a host read, an operation a
            capture does not take).
    """

    def __init__(self, fn: Callable, b: torch.Tensor):
        if b.device.type != "cuda":
            raise ValueError(f"CapturedSolve captures a CUDA graph and needs b on a CUDA "
                             f"device, got {b.device}; call the solve eagerly instead")
        from repro_torch.capture import capture

        self.b = b.detach().clone()
        self._captured = cap = capture(lambda: fn(self.b), b.device, "the solve")
        self.graph, (self.x, self.rs) = cap.graph, cap.out
        self.capture_s, self.instantiate_s = cap.capture_s, cap.instantiate_s
        self.nodes, self.launches = cap.nodes, cap.launches

    def __call__(self, b: torch.Tensor):
        """``(x, rs)`` for ``b`` (shape, dtype and device of the captured one)."""
        if b.shape != self.b.shape or b.dtype != self.b.dtype or b.device != self.b.device:
            raise ValueError(f"CapturedSolve was captured for b {tuple(self.b.shape)} "
                             f"{self.b.dtype} on {self.b.device}, got {tuple(b.shape)} "
                             f"{b.dtype} on {b.device}")
        self.b.copy_(b)
        self.graph.replay()
        return self.x.clone(), self.rs.clone()

    def stats(self) -> dict:
        return self._captured.stats()


class CGInfo(NamedTuple):
    """Result of a tolerance-stopping CG run."""

    x: torch.Tensor
    iters: int              # iterations actually taken
    rel_res: torch.Tensor   # final ||r|| / ||b|| (0-d tensor)


def cg(A, b: torch.Tensor, *, tol: float = 1e-6, maxiter: int = 500,
       precond: Optional[Callable] = None) -> CGInfo:
    """(P)CG until ``||r|| <= tol * ||b||`` or ``maxiter``.

    Example:
        >>> import numpy as np, scipy.sparse as sp
        >>> from repro_torch.core import as_operator
        >>> A = as_operator(sp.eye(8, format="csr") * 4.0, device="cpu")
        >>> info = cg(A, torch.ones(8), tol=1e-8)
        >>> info.iters, round(float(info.x[0]), 6)
        (1, 0.25)
    """
    spmv_fn = as_matvec(A)
    M = precond if precond is not None else (lambda r: r)
    bnorm = _floor(pnorm(b))
    z0 = M(b)
    x, r, p, rz, k = torch.zeros_like(b), b, z0, pdot(b, z0), 0
    while k < maxiter:
        rn = pnorm(r)
        # a non-finite residual exits the loop instead of spinning to maxiter
        if not bool(torch.isfinite(rn) & (rn > tol * bnorm)):
            break
        Ap = spmv_fn(p)
        alpha = rz / _floor(pdot(p, Ap))
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = M(r)
        rz_new = pdot(r, z)
        p = axpy(rz_new / _floor(rz), p, z)
        rz = rz_new
        k += 1
    return CGInfo(x, k, pnorm(r) / bnorm)


class CGDiagnostics(NamedTuple):
    """Post-run divergence analysis of a :class:`CGInfo`."""

    converged: bool   # rel_res <= tol
    finite: bool      # rel_res (and hence the residual) is finite
    stalled: bool     # hit maxiter with rel_res still above tol
    rel_res: float
    iters: int


def diagnose_cg(info: CGInfo, *, tol: float, maxiter: int) -> CGDiagnostics:
    """Classify a finished CG run: converged / non-finite / stalled."""
    rel = float(info.rel_res)
    iters = int(info.iters)
    finite = math.isfinite(rel)
    converged = finite and rel <= tol
    stalled = finite and not converged and iters >= maxiter
    return CGDiagnostics(converged=converged, finite=finite, stalled=stalled,
                         rel_res=rel, iters=iters)


def cg_guarded(A, b: torch.Tensor, *, tol: float = 1e-6, maxiter: int = 500,
               precond: Optional[Callable] = None, restart: bool = False):
    """:func:`cg` that raises :class:`SolverDivergenceError` on a
    non-finite or stalled run; with ``restart=True`` a non-finite run first
    retries once on the plain-first chain. Returns ``(CGInfo,
    CGDiagnostics)``."""
    from repro_torch.core.errors import SolverDivergenceError

    info = cg(A, b, tol=tol, maxiter=maxiter, precond=precond)
    diag = diagnose_cg(info, tol=tol, maxiter=maxiter)
    if not diag.finite and restart:
        info = cg(_degraded_matvec(A), b, tol=tol, maxiter=maxiter,
                  precond=precond)
        diag = diagnose_cg(info, tol=tol, maxiter=maxiter)
    if not diag.finite:
        raise SolverDivergenceError(
            f"CG produced a non-finite residual after {diag.iters} "
            f"iterations (rel_res={diag.rel_res}) — kernel fault or "
            f"ill-posed input")
    if diag.stalled:
        raise SolverDivergenceError(
            f"CG stalled: {diag.iters} iterations reached rel_res="
            f"{diag.rel_res:.3e}, target {tol:.3e}")
    return info, diag


def _degraded_matvec(A) -> Callable:
    """``A``'s matvec forced onto the plain-first chain when ``A`` carries a
    policy; callables and policy-less operators pass through unchanged."""
    pol = getattr(A, "_effective_policy", None)
    with_policy = getattr(A, "with_policy", None)
    if pol is None or with_policy is None:
        return as_matvec(A)
    base = pol()
    chain = ("plain",) + tuple(b for b in base.backends if b != "plain")
    return as_matvec(with_policy(base.replace(backends=chain,
                                              allow_fallback=True)))
