"""Morpheus-enabled HPCG (paper §VII-D) in PyTorch — the full benchmark.

The five phases of ``repro.apps.hpcg.run_hpcg``: (1) setup — the 27-point
stencil and the multigrid hierarchy; (2) reference run — preconditioned CG
with plain CSR operators at every level; (3) optimisation setup — the
run-first auto-tuner picks a (format, backend) for the main operator and
for every multigrid level; (4) validation — the optimised pipeline forced
onto the csr/plain candidates must reproduce the reference run bit for bit,
and the tuned run must converge to ``tol`` and agree with the reference;
(5) timed runs — fixed-iteration PCG, so the op counts match across
implementations. The distributed variant waits for ROADMAP queue 1, item 8.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import DispatchKey, as_operator, autotune_spmv, resolve_device
from repro_torch.core import matrices as M
from repro_torch.core.errors import SolverDivergenceError
from repro_torch.solvers import build_mg, cg, cg_solve, diagnose_cg, pcg_solve  # noqa: F401

REFERENCE_CANDIDATES = (DispatchKey("csr", "plain"),)


@dataclass
class HPCGResult:
    grid: Tuple[int, int, int]
    n: int
    iters: int
    ref_time_s: float
    opt_time_s: float
    speedup: float
    chosen: str
    valid: bool
    rel_err: float
    table: Dict = field(default_factory=dict)
    precond: bool = False
    pcg_iters: int = 0        # iterations the tuned PCG took to reach tol
    rel_res: float = 0.0      # its final ||r||/||b||
    bitwise: bool = True      # optimised machinery on csr/plain == reference
    mg_levels: str = ""       # per-level (format, backend) choices
    skipped: list = field(default_factory=list)  # the main tune's skipped keys


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, reps=3, device):
    fn(*args)
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _guard_phase(info, phase: str, *, tol, maxiter):
    """Fail loudly when a convergence phase went non-finite; a merely
    stalled run stays a validation failure."""
    diag = diagnose_cg(info, tol=tol, maxiter=maxiter)
    if not diag.finite:
        raise SolverDivergenceError(
            f"HPCG {phase} phase diverged: non-finite residual after "
            f"{diag.iters} iterations")
    return diag


def _solver_pair(A_op, mg, iters, tol):
    """(timed, convergence) solvers for one operator set."""
    matvec = lambda p: A_op @ p  # noqa: E731
    timed = lambda b: pcg_solve(matvec, b, iters, precond=mg)  # noqa: E731
    conv = lambda b: cg(matvec, b, tol=tol, maxiter=iters, precond=mg)  # noqa: E731
    return timed, conv


def run_hpcg(nx=16, ny=16, nz=16, iters=50, reps=3, candidates=None,
             verbose=True, precond=True, tol=1e-6, depth=4,
             timed=True, tune_mode="run", device="cuda") -> HPCGResult:
    """Serial HPCG phases 1-5 on ``device`` (default ``"cuda"``).

    ``timed=False`` runs phases 1-4 only and reports zero times.
    ``tune_mode="predict"`` needs the zero-run selector (ROADMAP queue 1,
    item 4) and raises.
    """
    if tune_mode == "predict":
        raise NotImplementedError(
            "run_hpcg(tune_mode='predict') needs the zero-run selector, not "
            "ported yet (ROADMAP queue 1, item 4: core/select.py)")
    if tune_mode != "run":
        raise ValueError(f"tune_mode {tune_mode!r}: expected 'run' or 'predict'")
    dev = resolve_device(device)
    # Phase 1: problem setup (stencil + multigrid hierarchy)
    A_sp = M.fdm27(nx, ny, nz)
    n = A_sp.shape[0]
    b = torch.from_numpy((A_sp @ np.ones(n)).astype(np.float32)).to(dev)

    # Phase 2: reference run (plain CSR at every level)
    A_ref = as_operator(A_sp, "csr", device=dev).using("plain")
    mg_ref = build_mg(nx, ny, nz, depth=depth, fmt="csr", device=dev) if precond else None
    ref_timed, ref_conv = _solver_pair(A_ref, mg_ref, iters, tol)
    ref = ref_conv(b)
    _guard_phase(ref, "reference", tol=tol, maxiter=iters)
    x_ref = ref.x

    # Phase 3: optimisation setup (per-level formats, Table III style)
    tune = autotune_spmv(A_sp, candidates=candidates, device=dev)
    A_opt, impl = tune.operator, tune.impl
    chosen = f"{tune.format}/{impl}"
    tune_table = {f"{f}/{i}": t for (f, i), t in tune.table.items()}
    mg_opt = mg_ref.retuned(candidates) if precond else None
    opt_timed, opt_conv = _solver_pair(A_opt, mg_opt, iters, tol)

    # Phase 4: validation
    #  (a) bit-for-bit: the optimised pipeline on the csr/plain candidates
    A_chk = autotune_spmv(A_sp, candidates=REFERENCE_CANDIDATES, device=dev).operator
    mg_chk = mg_ref.retuned(REFERENCE_CANDIDATES) if precond else None
    _, chk_conv = _solver_pair(A_chk, mg_chk, iters, tol)
    chk = chk_conv(b)
    bitwise = bool(torch.equal(chk.x, x_ref) and int(chk.iters) == int(ref.iters))
    #  (b) tolerance: the tuned run must converge and agree with the reference
    opt = opt_conv(b)
    _guard_phase(opt, "optimised", tol=tol, maxiter=iters)
    rel = float(torch.linalg.vector_norm(opt.x - x_ref)
                / torch.clamp(torch.linalg.vector_norm(x_ref), min=1e-30))
    valid = bitwise and rel < 1e-3 and float(opt.rel_res) <= tol

    # Phase 5: timed runs (fixed iteration count => identical op mix)
    if timed:
        t_ref = _time(ref_timed, b, reps=reps, device=dev)
        t_opt = _time(opt_timed, b, reps=reps, device=dev)
        speedup = t_ref / t_opt
    else:
        t_ref = t_opt = 0.0
        speedup = 0.0

    res = HPCGResult(
        (nx, ny, nz), n, iters, t_ref, t_opt, speedup,
        chosen, valid, rel, tune_table,
        precond=precond, pcg_iters=int(opt.iters), rel_res=float(opt.rel_res),
        bitwise=bitwise, mg_levels=mg_opt.describe() if mg_opt else "",
        skipped=list(tune.skipped))
    if verbose:
        kind = "pcg" if precond else "cg"
        print(f"HPCG {nx}x{ny}x{nz} n={n} on {dev}: ref(csr/plain)={t_ref*1e3:.1f}ms "
              f"opt({res.chosen})={t_opt*1e3:.1f}ms speedup={res.speedup:.2f}x "
              f"{kind}_iters={res.pcg_iters} rel_res={res.rel_res:.2e} "
              f"valid={valid} bitwise={bitwise} rel={rel:.2e}")
        if res.mg_levels:
            print(f"  levels: {res.mg_levels}")
    return res
