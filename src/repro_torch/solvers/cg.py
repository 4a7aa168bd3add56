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
captured once in a CUDA graph and replayed as one launch. Its tolerance
solve is a ``lax.while_loop`` whose stop is a device value;
:class:`CapturedCG` is the port's form of that: the setup and a chunk of
iterations (:func:`cg_chunk`, each iteration applied only while the
reference's ``cond`` holds) captured once, the chunk replayed until the
device's flag drops, one host read a replay.
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


#: Iterations in one replay of :class:`CapturedCG`'s chunk. A replay
#: boundary costs a host read and a launch; an iteration computed past the
#: stop costs a whole iteration, discarded (chosen from HPCG's shapes; see
#: PERF.md).
CG_CHUNK = 2


class CGState(NamedTuple):
    """The tolerance CG's loop state on the device: the reference's
    ``(x, r, p, rz, k)`` and ``active``, its ``cond`` for the next
    iteration."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor      # 0-d
    k: torch.Tensor       # 0-d int64: iterations taken
    active: torch.Tensor  # 0-d bool


def _cg_cond(r: torch.Tensor, k: torch.Tensor, bnorm: torch.Tensor, tol: float,
             maxiter: int) -> torch.Tensor:
    """The reference's ``cond``: a finite residual above ``tol * ||b||`` and
    ``k < maxiter`` (a non-finite residual stops the loop)."""
    rn = pnorm(r)
    return torch.isfinite(rn) & (rn > tol * bnorm) & (k < maxiter)


def cg_start(b: torch.Tensor, *, tol: float = 1e-6, maxiter: int = 500,
             precond: Optional[Callable] = None):
    """``(state, bnorm)``: :func:`cg`'s state before its first iteration,
    with ``active`` its first ``cond``."""
    M = precond if precond is not None else (lambda r: r)
    bnorm = _floor(pnorm(b))
    z0 = M(b)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    state = CGState(torch.zeros_like(b), b, z0, pdot(b, z0), k,
                    _cg_cond(b, k, bnorm, tol, maxiter))
    return state, bnorm


def cg_chunk(state: CGState, A, *, bnorm: torch.Tensor, tol: float = 1e-6,
             maxiter: int = 500, precond: Optional[Callable] = None,
             chunk: int = CG_CHUNK) -> CGState:
    """``chunk`` iterations of :func:`cg`'s body under the device flag
    ``state.active``, with no host read.

    Each iteration computes the eager body's arithmetic in its order and
    keeps it where the flag holds (``torch.where``); ``k`` grows by the
    flag, and the flag is the reference's ``cond`` recomputed after each
    iteration. Once it drops, the rest of the chunk computes values and
    discards them, so the state is :func:`cg`'s, bit for bit, at every
    chunk size.
    """
    spmv_fn = as_matvec(A)
    M = precond if precond is not None else (lambda r: r)
    x, r, p, rz, k, active = state
    for _ in range(chunk):
        Ap = spmv_fn(p)
        alpha = rz / _floor(pdot(p, Ap))
        x_new = axpy(alpha, p, x)
        r_new = axpy(-alpha, Ap, r)
        z = M(r_new)
        rz_new = pdot(r_new, z)
        p_new = axpy(rz_new / _floor(rz), p, z)
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        k = k + active
        active = _cg_cond(r, k, bnorm, tol, maxiter)
    return CGState(x, r, p, rz, k, active)


def _on_card(b: torch.Tensor) -> bool:
    return b.device.type == "cuda"


class CapturedCG:
    """The tolerance CG (:func:`cg`) as two CUDA graphs with its stop on
    the device: the counterpart of the reference's ``lax.while_loop``
    (``repro.solvers.cg.cg``) under ``jax.jit``.

    Construction captures, through :func:`repro_torch.capture.capture`,
    the setup (:func:`cg_start` on a static ``b``) and one
    :func:`cg_chunk` of ``chunk`` iterations; both write the loop state
    into static buffers, and both end with the flag for the next
    iteration. A call copies ``b`` in, replays the setup, then replays the
    chunk while the flag holds, reading the flag and ``k`` from the device
    once after each replay (the setup's included). A solve of ``k``
    iterations replays the chunk ``ceil(k / chunk)`` times and computes
    ``(-k) mod chunk`` iterations it discards. ``x``, ``iters`` and
    ``rel_res`` are :func:`cg`'s bits; ``x`` is cloned out of the static
    buffer.

    Python runs only at the two warm-ups and the two captures: launch
    counters and the health registry count those, never a replay.

    Raises:
        ValueError: ``b`` is not on a CUDA device (the eager loop is the
            caller's choice, never a stand-in), or ``chunk < 1``.
        CaptureError: a capture failed (a host read, an operation a capture
            does not take); nothing runs eagerly in its place.
    """

    def __init__(self, A, b: torch.Tensor, *, tol: float = 1e-6, maxiter: int = 500,
                 precond: Optional[Callable] = None, chunk: int = CG_CHUNK):
        if not _on_card(b):
            raise ValueError(f"CapturedCG captures CUDA graphs and needs b on a CUDA "
                             f"device, got {b.device}; call cg eagerly instead")
        if chunk < 1:
            raise ValueError(f"CapturedCG: chunk must be >= 1, got {chunk}")
        from repro_torch.capture import capture

        self.chunk = int(chunk)
        self.b = b.detach().clone()
        zero = lambda dtype: torch.zeros((), dtype=dtype, device=b.device)  # noqa: E731
        self.state = CGState(torch.zeros_like(b), torch.zeros_like(b), torch.zeros_like(b),
                             zero(b.dtype), zero(torch.int64), zero(torch.bool))
        self.bnorm = zero(b.dtype)
        self._status = torch.zeros(2, dtype=torch.int64, device=b.device)  # k, active

        def setup():
            state, bnorm = cg_start(self.b, tol=tol, maxiter=maxiter, precond=precond)
            self.bnorm.copy_(bnorm)
            self._store(state)

        def step():
            self._store(cg_chunk(self.state, A, bnorm=self.bnorm, tol=tol, maxiter=maxiter,
                                 precond=precond, chunk=self.chunk))

        self._setup = capture(setup, b.device, "the tolerance CG's setup")
        self._step = capture(step, b.device, f"the tolerance CG's chunk of {chunk}")
        self.last = {}  # the last call's iterations taken, computed and replays

    def _store(self, state: CGState) -> None:
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        torch.stack((state.k, state.active.long()), out=self._status)

    def __call__(self, b: torch.Tensor) -> CGInfo:
        """:func:`cg`'s result for ``b`` (shape, dtype and device of the
        captured one)."""
        if b.shape != self.b.shape or b.dtype != self.b.dtype or b.device != self.b.device:
            raise ValueError(f"CapturedCG was captured for b {tuple(self.b.shape)} "
                             f"{self.b.dtype} on {self.b.device}, got {tuple(b.shape)} "
                             f"{b.dtype} on {b.device}")
        self.b.copy_(b)
        self._setup.graph.replay()
        k, active = self._status.tolist()
        replays = 0
        while active:
            self._step.graph.replay()
            k, active = self._status.tolist()
            replays += 1
        self.last = {"iters": k, "computed": replays * self.chunk, "replays": replays}
        return CGInfo(self.state.x.clone(), k, pnorm(self.state.r) / self.bnorm)

    def stats(self) -> dict:
        """Both graphs' capture and instantiation seconds and nodes, the
        chunk's kernel launches a replay, and the last call's iterations
        taken and computed and its replays (host reads: replays + 1)."""
        return {"chunk": self.chunk,
                "capture_s": self._setup.capture_s + self._step.capture_s,
                "instantiate_s": self._setup.instantiate_s + self._step.instantiate_s,
                "nodes": self._step.nodes, "setup_nodes": self._setup.nodes,
                "launches": dict(self._step.launches), **self.last}


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
