"""Morpheus-enabled HPCG (paper §VII-D) in PyTorch — the full benchmark.

The five phases of ``repro.apps.hpcg.run_hpcg``: (1) setup — the 27-point
stencil and the multigrid hierarchy; (2) reference run — preconditioned CG
with plain CSR operators at every level; (3) optimisation setup — the
run-first auto-tuner (or, with ``tune_mode="predict"``, the zero-run
selector) picks a (format, backend) for the main operator and for every
multigrid level; (4) validation — the optimised pipeline forced
onto the csr/plain candidates must reproduce the reference run bit for bit,
and the tuned run must converge to ``tol`` and agree with the reference;
(5) timed runs — fixed-iteration PCG, so the op counts match across
implementations. ``run_hpcg_distributed`` runs the same five phases over a
mesh of parts (``repro.apps.hpcg.run_hpcg_distributed``): every operator,
each multigrid level and the SymGS color sweeps included, is a
``DistributedOperator`` with halo-exchange SpMV, and validation also demands
that the distributed csr/plain SpMV equal the single-device one bit for bit.
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
    ``tune_mode="predict"`` swaps phase 3's races (main operator and every
    multigrid level) for the zero-run selector, on the cost table of
    ``device``: setup runs no candidate kernel, and validation is the same,
    so a bad prediction fails a check rather than passing silently.
    """
    if tune_mode not in ("run", "predict"):
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

    # Phase 3: optimisation setup (per-level formats, Table III style):
    # "run" races the candidates, "predict" ranks them without a kernel
    if tune_mode == "predict":
        A_opt = as_operator(A_sp, "csr", device=dev).tune(candidates=candidates,
                                                          mode="predict")
        chosen, tune_table, skipped = f"{A_opt.format}/{A_opt.policy.backends[0]}", {}, []
    else:
        tune = autotune_spmv(A_sp, candidates=candidates, device=dev)
        A_opt = tune.operator
        chosen = f"{tune.format}/{tune.impl}"
        tune_table = {f"{f}/{i}": t for (f, i), t in tune.table.items()}
        skipped = list(tune.skipped)
    mg_opt = mg_ref.retuned(candidates, mode=tune_mode) if precond else None
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
        skipped=skipped)
    if verbose:
        kind = "pcg" if precond else "cg"
        print(f"HPCG {nx}x{ny}x{nz} n={n} on {dev}: ref(csr/plain)={t_ref*1e3:.1f}ms "
              f"opt({res.chosen})={t_opt*1e3:.1f}ms speedup={res.speedup:.2f}x "
              f"{kind}_iters={res.pcg_iters} rel_res={res.rel_res:.2e} "
              f"valid={valid} bitwise={bitwise} rel={rel:.2e}")
        if res.mg_levels:
            print(f"  levels: {res.mg_levels}")
    return res


def default_mesh(axis: str = "data", device="cuda", parts=None):
    """A 1-D ``PartMesh``: ``parts`` parts all on ``device``, or with
    ``parts=None`` one part on every visible device of its type (every
    card; the host is one device)."""
    from repro_torch.core.distributed import PartMesh

    dev = resolve_device(device)
    if parts is not None:
        return PartMesh.on(dev, parts, axis)
    if dev.type == "cuda":
        return PartMesh(tuple(torch.device("cuda", i)
                              for i in range(torch.cuda.device_count())), axis)
    return PartMesh((dev,), axis)


def run_hpcg_distributed(mesh=None, nx=16, ny=16, nz=16, iters=50, reps=3,
                         candidates=None, verbose=True, precond=True,
                         tol=1e-6, depth=4, timed=True, axis="data",
                         tune_levels=False, device="cuda") -> HPCGResult:
    """Distributed HPCG — the full pipeline over a mesh of parts.

    Rows (matrix, multigrid levels) are partitioned over ``mesh[axis]``;
    every SpMV is a ``DistributedOperator`` (per part: the halo exchange,
    local-part SpMV, remote-part SpMV), and vectors stay global on the
    mesh's home device, where CG's dot products run.

    Phases:
      1. *setup* — stencil + right-hand side + the multigrid hierarchy,
         clamped to :func:`repro_torch.solvers.distributable_depth`.
      2. *reference* — the single-device csr/plain PCG solve on the home
         device (the oracle the distributed runs are judged against).
      3. *tune* — :func:`repro_torch.distributed_op.tune_partitions` picks
         each part's (local, remote) formats (Table III);
         ``tune_levels=True`` also retunes every multigrid level per part.
      4. *validate* — (a) **bit-for-bit**: the distributed csr/plain SpMV in
         ``rowblock`` mode must equal the single-device csr/plain SpMV
         exactly; (b) *tolerance*: the tuned distributed PCG must converge
         to ``tol`` and agree with the single-device solution.
      5. *timed* — fixed-iteration distributed PCG, reference split
         (csr/csr) vs tuned formats, identical op mix.

    Args:
        mesh: a ``PartMesh`` (default: :func:`default_mesh` on ``device``).
        nx, ny, nz: stencil grid; ``nx*ny*nz`` must be divisible by the
            part count.
        iters, reps, candidates, precond, tol, depth, timed: as
            :func:`run_hpcg`; ``depth`` is clamped to what partitions evenly.
        tune_levels: per-partition tune of every MG level (slower setup).
        device: where ``default_mesh`` puts the parts when ``mesh`` is None.

    Returns:
        :class:`HPCGResult`; ``bitwise`` is tier (a), ``valid`` ands both
        tiers with convergence, ``chosen``/``mg_levels`` describe the
        per-part and per-level choices; ``chosen`` follows a part's choice
        with the key dispatch runs where the two differ.
    """
    from repro_torch.core.distributed import mesh_parts
    from repro_torch.distributed_op import DistributedOperator, tune_partitions
    from repro_torch.solvers import distributable_depth, distribute_vcycle

    if mesh is None:
        mesh = default_mesh(axis, device)
    nparts = mesh_parts(mesh, axis)
    home = mesh.home

    # Phase 1: problem setup
    A_sp = M.fdm27(nx, ny, nz)
    n = A_sp.shape[0]
    if n % nparts:
        raise ValueError(f"grid {nx}x{ny}x{nz} ({n} rows) is not divisible "
                         f"by the {nparts}-part mesh")
    b_host = np.asarray(A_sp @ np.ones(n), np.float32)
    depth = distributable_depth(nx, ny, nz, nparts, depth=depth) if precond else 0

    # Phase 2: single-device reference (csr/plain, the oracle)
    A_ref = as_operator(A_sp, "csr", device=home).using("plain")
    mg_ref = build_mg(nx, ny, nz, depth=depth, fmt="csr", device=home) if precond else None
    b1 = torch.from_numpy(b_host).to(home)
    ref = cg(lambda p: A_ref @ p, b1, tol=tol, maxiter=iters, precond=mg_ref)
    x_ref = ref.x

    # Phase 3: distributed operators — reference split + per-partition tune
    D_ref = DistributedOperator.build(A_sp, mesh, axis, local="csr",
                                      remote="csr", mode="auto")
    D_opt, table = tune_partitions(A_sp, mesh, axis, candidates=candidates)
    mg_dist = distribute_vcycle(mg_ref, mesh, axis, tune=tune_levels,
                                candidates=candidates) if precond else None
    b_d = D_ref.device_put(b_host)

    # Phase 4a: bit-for-bit — distributed csr/plain in rowblock (exact) mode
    # must reproduce the single-device csr/plain SpMV bit by bit.
    D_chk = DistributedOperator.build(A_sp, mesh, axis, local="csr",
                                      mode="rowblock")
    bitwise = bool(torch.equal(A_ref @ b1, D_chk @ b_d))

    # Phase 4b: tolerance — tuned distributed PCG converges and matches
    opt = cg(lambda p: D_opt @ p, b_d, tol=tol, maxiter=iters, precond=mg_dist)
    rel = float(torch.linalg.vector_norm(opt.x - x_ref)
                / torch.clamp(torch.linalg.vector_norm(x_ref), min=1e-30))
    valid = bitwise and rel < 1e-3 and float(opt.rel_res) <= tol

    # Phase 5: timed fixed-iteration runs (identical op mix)
    if timed:
        t_ref = _time(lambda b: pcg_solve(lambda p: D_ref @ p, b, iters, precond=mg_dist),
                      b_d, reps=reps, device=home)
        t_opt = _time(lambda b: pcg_solve(lambda p: D_opt @ p, b, iters, precond=mg_dist),
                      b_d, reps=reps, device=home)
        speedup = t_ref / t_opt
    else:
        t_ref = t_opt = speedup = 0.0

    flat_table = {f"p{p}/{part}": {f"{f}/{i}": t for (f, i), t in tbl.items()}
                  for (p, part), tbl in table.items()}
    res = HPCGResult(
        (nx, ny, nz), n, iters, t_ref, t_opt, speedup,
        D_opt.describe(dispatched=True), valid, rel, flat_table,
        precond=precond, pcg_iters=int(opt.iters), rel_res=float(opt.rel_res),
        bitwise=bitwise, mg_levels=mg_dist.describe() if mg_dist else "")
    if verbose:
        kind = "pcg" if precond else "cg"
        print(f"HPCG-dist {nx}x{ny}x{nz} n={n} parts={nparts} on {home}: "
              f"ref={t_ref*1e3:.1f}ms opt={t_opt*1e3:.1f}ms "
              f"speedup={speedup:.2f}x {kind}_iters={res.pcg_iters} "
              f"rel_res={res.rel_res:.2e} valid={valid} bitwise={bitwise} "
              f"rel={rel:.2e}")
        print(f"  per-part: {res.chosen}")
        if res.mg_levels:
            print(f"  levels: {res.mg_levels}")
    return res
