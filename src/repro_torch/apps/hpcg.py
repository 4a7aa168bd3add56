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
implementations. On a CUDA device each timed solve is captured once in a
CUDA graph and timed by its replays (``graph=None``, the default, captures
on the card and runs eagerly on the host; ``graph=True`` raises there), as
the reference times its ``jax.jit``-compiled solve; the eager loop is timed
beside it, and every replay must give the eager solve's bits
(``graph_equal``). A captured run's every tolerance solve (phases 2 and
4) is :class:`~repro_torch.solvers.CapturedCG`, the reference's jitted
``lax.while_loop``: a setup and a chunk of iterations captured, the chunk
replayed until the device's flag drops; it gives the eager ``cg``'s bits.
``run_hpcg_distributed`` runs the same five phases over a mesh of parts
(``repro.apps.hpcg.run_hpcg_distributed``): every operator,
each multigrid level and the SymGS color sweeps included, is a
``DistributedOperator`` with halo-exchange SpMV, and validation also demands
that the distributed csr/plain SpMV equal the single-device one bit for bit.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import DispatchKey, as_operator, autotune_spmv, resolve_device
from repro_torch.core import matrices as M
from repro_torch.core.errors import SolverDivergenceError
from repro_torch.solvers import (  # noqa: F401
    CapturedCG, CapturedSolve, build_mg, cg, cg_solve, diagnose_cg, pcg_solve,
)

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
    graph: bool = False       # the solves ran captured (the timed ones a graph's replays)
    ref_eager_s: float = 0.0  # the eager loop's median (ref_time_s without a graph)
    opt_eager_s: float = 0.0
    graph_equal: bool = False  # every replay gave the eager solve's x and rs bits
    graphs: Dict = field(default_factory=dict)  # "ref"/"opt": CapturedSolve.stats()
    # the tolerance solves' CapturedCG.stats() by solve ("ref", "chk", "opt"),
    # with the captured call's seconds and, where asked for, the eager cg's
    # seconds beside it and whether both gave equal x bits and iterations
    conv_graphs: Dict = field(default_factory=dict)


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


class _Timed(NamedTuple):
    seconds: float        # the replay's median with a graph, else the eager loop's
    eager_s: float        # the eager loop's median
    equal: bool           # every replay gave the eager bits (False without a graph)
    stats: Dict           # CapturedSolve.stats(), {} without a graph


@contextlib.contextmanager
def _no_host_reads(device: torch.device):
    """Every synchronizing call on ``device`` raises inside (PyTorch's sync
    debug mode): a warm solve that a graph can capture reads nothing."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _time_solve(fn, b, *, reps: int, eager_reps: int, graph: bool, device) -> _Timed:
    """Time the fixed-iteration solve ``fn(b) -> (x, rs)``.

    Without a graph: the eager loop's median over ``reps`` after a warm
    call. With one: :class:`CapturedSolve` (its warm-up is the warm call),
    then ``eager_reps`` eager solves, each with no host read allowed, then
    one warm replay and ``reps`` timed ones, each held to the last eager
    solve's ``x`` and ``rs`` bit for bit.
    """
    if not graph:
        t = _time(fn, b, reps=reps, device=device)
        return _Timed(t, t, False, {})
    if eager_reps < 1:
        raise ValueError(f"eager_reps={eager_reps}: the replays are held to an eager solve")
    solve = CapturedSolve(fn, b)
    ts = []
    for _ in range(eager_reps):
        t0 = time.perf_counter()
        with _no_host_reads(device):
            x_e, rs_e = fn(b)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    outs = [solve(b)]
    _sync(device)
    tg = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs.append(solve(b))
        _sync(device)
        tg.append(time.perf_counter() - t0)
    equal = all(torch.equal(x, x_e) and torch.equal(rs, rs_e) for x, rs in outs)
    return _Timed(float(np.median(tg)), float(np.median(ts)), equal, solve.stats())


def _check_graph(graph: bool, devices) -> None:
    """Captured solves need their operands on one CUDA device."""
    if not graph:
        return
    devs = set(devices)
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"graph=True captures the solves in CUDA graphs and needs "
                         f"a CUDA device, got {sorted(map(str, devs))}; pass graph=False "
                         f"to run the eager loops")
    if len(devs) > 1:
        raise ValueError(f"graph=True captures one device's stream; the mesh spans "
                         f"{sorted(map(str, devs))}. A capture across cards is not "
                         f"implemented: pass graph=False to time the eager loop")


def _resolve_graph(graph: Optional[bool], devices) -> bool:
    """Whether the solves run captured: ``graph=None`` captures where every
    operand lives on one CUDA device and is eager elsewhere (the host, a
    mesh over several cards); ``graph=True`` captures and raises where it
    cannot (:func:`_check_graph`); ``graph=False`` is eager."""
    if graph is None:
        devs = set(devices)
        return len(devs) == 1 and next(iter(devs)).type == "cuda"
    _check_graph(graph, devices)
    return bool(graph)


def _guard_phase(info, phase: str, *, tol, maxiter):
    """Fail loudly when a convergence phase went non-finite; a merely
    stalled run stays a validation failure."""
    diag = diagnose_cg(info, tol=tol, maxiter=maxiter)
    if not diag.finite:
        raise SolverDivergenceError(
            f"HPCG {phase} phase diverged: non-finite residual after "
            f"{diag.iters} iterations")
    return diag


def _fixed_solve(A_op, mg, iters):
    """The fixed-iteration (timed) solve ``b -> (x, rs)`` for one operator set."""
    return lambda b: pcg_solve(lambda p: A_op @ p, b, iters, precond=mg)


def _conv_solve(name: str, A_op, mg, b, *, iters, tol, graph: bool, eager: tuple,
                stats: dict, device):
    """The tolerance solve ``name``: eager :func:`cg` without a graph, else
    :class:`CapturedCG` (its stats and the captured call's seconds go to
    ``stats[name]``); a ``name`` in ``eager`` also runs the eager ``cg``
    after it, timed, and records whether both gave equal ``x`` bits and
    iterations."""
    matvec = lambda p: A_op @ p  # noqa: E731
    if not graph:
        return cg(matvec, b, tol=tol, maxiter=iters, precond=mg)
    solver = CapturedCG(matvec, b, tol=tol, maxiter=iters, precond=mg)
    t0 = time.perf_counter()
    info = solver(b)
    _sync(device)
    st = stats[name] = dict(solver.stats(), seconds=time.perf_counter() - t0)
    if name in eager:
        t0 = time.perf_counter()
        want = cg(matvec, b, tol=tol, maxiter=iters, precond=mg)
        _sync(device)
        st["eager_s"] = time.perf_counter() - t0
        st["equal"] = bool(torch.equal(info.x, want.x) and info.iters == want.iters)
    return info


def run_hpcg(nx=16, ny=16, nz=16, iters=50, reps=3, candidates=None,
             verbose=True, precond=True, tol=1e-6, depth=4,
             timed=True, tune_mode="run", device="cuda", graph=None,
             eager_reps=None, conv_eager=()) -> HPCGResult:
    """Serial HPCG phases 1-5 on ``device`` (default ``"cuda"``).

    ``timed=False`` runs phases 1-4 only and reports zero times.
    ``tune_mode="predict"`` swaps phase 3's races (main operator and every
    multigrid level) for the zero-run selector, on the cost table of
    ``device``: setup runs no candidate kernel, and validation is the same,
    so a bad prediction fails a check rather than passing silently.
    A captured run times each fixed-iteration solve by the replays of one
    CUDA graph (``reps`` of them) and the eager loop beside it
    (``eager_reps``, default ``reps``), and runs each tolerance solve
    (``"ref"``, ``"chk"``, ``"opt"``) through :class:`CapturedCG`; it
    raises when a capture fails. ``graph=None`` (the default) captures on
    a CUDA device and runs eagerly on the host; ``graph=True`` captures
    and raises on the host, whatever ``timed`` says; ``graph=False`` runs
    every solve eagerly. ``HPCGResult.graph`` records which ran.
    ``conv_eager`` names tolerance solves to run eagerly too, beside the
    captured one (``conv_graphs``).
    """
    if tune_mode not in ("run", "predict"):
        raise ValueError(f"tune_mode {tune_mode!r}: expected 'run' or 'predict'")
    dev = resolve_device(device)
    graph = _resolve_graph(graph, (dev,))
    conv = {}
    solve = lambda name, A_op, mg: _conv_solve(  # noqa: E731
        name, A_op, mg, b, iters=iters, tol=tol, graph=graph, eager=tuple(conv_eager),
        stats=conv, device=dev)
    # Phase 1: problem setup (stencil + multigrid hierarchy)
    A_sp = M.fdm27(nx, ny, nz)
    n = A_sp.shape[0]
    b = torch.from_numpy((A_sp @ np.ones(n)).astype(np.float32)).to(dev)

    # Phase 2: reference run (plain CSR at every level)
    A_ref = as_operator(A_sp, "csr", device=dev).using("plain")
    mg_ref = build_mg(nx, ny, nz, depth=depth, fmt="csr", device=dev) if precond else None
    ref = solve("ref", A_ref, mg_ref)
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

    # Phase 4: validation
    #  (a) bit-for-bit: the optimised pipeline on the csr/plain candidates
    A_chk = autotune_spmv(A_sp, candidates=REFERENCE_CANDIDATES, device=dev).operator
    mg_chk = mg_ref.retuned(REFERENCE_CANDIDATES) if precond else None
    chk = solve("chk", A_chk, mg_chk)
    bitwise = bool(torch.equal(chk.x, x_ref) and int(chk.iters) == int(ref.iters))
    #  (b) tolerance: the tuned run must converge and agree with the reference
    opt = solve("opt", A_opt, mg_opt)
    _guard_phase(opt, "optimised", tol=tol, maxiter=iters)
    rel = float(torch.linalg.vector_norm(opt.x - x_ref)
                / torch.clamp(torch.linalg.vector_norm(x_ref), min=1e-30))
    valid = bitwise and rel < 1e-3 and float(opt.rel_res) <= tol

    # Phase 5: timed runs (fixed iteration count => identical op mix)
    res = HPCGResult(
        (nx, ny, nz), n, iters, 0.0, 0.0, 0.0,
        chosen, valid, rel, tune_table,
        precond=precond, pcg_iters=int(opt.iters), rel_res=float(opt.rel_res),
        bitwise=bitwise, mg_levels=mg_opt.describe() if mg_opt else "",
        skipped=skipped, graph=graph, conv_graphs=conv)
    if timed:
        _timed_phase(res, _fixed_solve(A_ref, mg_ref, iters),
                     _fixed_solve(A_opt, mg_opt, iters), b, reps=reps,
                     eager_reps=eager_reps, graph=graph, device=dev)
    if verbose:
        kind = "pcg" if precond else "cg"
        print(f"HPCG {nx}x{ny}x{nz} n={n} on {dev}: ref(csr/plain)={res.ref_time_s*1e3:.1f}ms "
              f"opt({res.chosen})={res.opt_time_s*1e3:.1f}ms speedup={res.speedup:.2f}x "
              f"{kind}_iters={res.pcg_iters} rel_res={res.rel_res:.2e} "
              f"valid={valid} bitwise={bitwise} rel={rel:.2e}")
        _print_graph(res)
        if res.mg_levels:
            print(f"  levels: {res.mg_levels}")
    return res


def _timed_phase(res: HPCGResult, ref_timed, opt_timed, b, *, reps, eager_reps, graph,
                 device) -> None:
    """Phase 5 into ``res``: the reference and the tuned fixed-iteration
    solves, each timed by :func:`_time_solve`."""
    eager_reps = reps if eager_reps is None else eager_reps
    ref = _time_solve(ref_timed, b, reps=reps, eager_reps=eager_reps, graph=graph,
                      device=device)
    opt = _time_solve(opt_timed, b, reps=reps, eager_reps=eager_reps, graph=graph,
                      device=device)
    res.ref_time_s, res.opt_time_s = ref.seconds, opt.seconds
    res.speedup = ref.seconds / opt.seconds
    res.ref_eager_s, res.opt_eager_s = ref.eager_s, opt.eager_s
    res.graph_equal = ref.equal and opt.equal
    res.graphs = {"ref": ref.stats, "opt": opt.stats} if graph else {}


def _print_graph(res: HPCGResult) -> None:
    for name, st in res.conv_graphs.items():
        print(f"  conv graph {name}: iters={st['iters']} computed={st['computed']} "
              f"replays={st['replays']} capture={st['capture_s']:.3f}s "
              f"instantiate={st['instantiate_s']:.3f}s nodes={st['nodes']} "
              f"seconds={st['seconds']:.4f}"
              + (f" eager={st['eager_s']:.4f}s equal={st['equal']}" if "equal" in st else ""))
    if not res.graphs:
        return
    print(f"  eager: ref={res.ref_eager_s*1e3:.1f}ms opt={res.opt_eager_s*1e3:.1f}ms "
          f"graph_equal={res.graph_equal}")
    for name, st in res.graphs.items():
        print(f"  graph {name}: capture={st['capture_s']:.3f}s "
              f"instantiate={st['instantiate_s']:.3f}s nodes={st['nodes']} "
              f"launches={st['launches']}")


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
                         tune_levels=False, device="cuda", graph=None,
                         eager_reps=None, conv_eager=()) -> HPCGResult:
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
         (csr/csr) vs tuned formats, identical op mix; captured in a CUDA
         graph as :func:`run_hpcg` captures it, which needs every part on
         one CUDA device. With ``graph=True`` the tolerance solves of
         phases 2 and 4b are :class:`CapturedCG` too.

    Args:
        mesh: a ``PartMesh`` (default: :func:`default_mesh` on ``device``).
        nx, ny, nz: stencil grid; ``nx*ny*nz`` must be divisible by the
            part count.
        iters, reps, candidates, precond, tol, depth, timed, graph,
            eager_reps, conv_eager: as :func:`run_hpcg` (the tolerance
            solves are ``"ref"`` and ``"opt"``); ``depth`` is clamped to what
            partitions evenly. ``graph=None`` captures where every part
            lies on one CUDA device and is eager on the host and on a mesh
            of several devices, where ``graph=True`` raises.
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
    graph = _resolve_graph(graph, (home, *mesh.devices))
    conv = {}

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
    ref = _conv_solve("ref", A_ref, mg_ref, b1, iters=iters, tol=tol, graph=graph,
                      eager=tuple(conv_eager), stats=conv, device=home)
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
    opt = _conv_solve("opt", D_opt, mg_dist, b_d, iters=iters, tol=tol, graph=graph,
                      eager=tuple(conv_eager), stats=conv, device=home)
    rel = float(torch.linalg.vector_norm(opt.x - x_ref)
                / torch.clamp(torch.linalg.vector_norm(x_ref), min=1e-30))
    valid = bitwise and rel < 1e-3 and float(opt.rel_res) <= tol

    # Phase 5: timed fixed-iteration runs (identical op mix)
    flat_table = {f"p{p}/{part}": {f"{f}/{i}": t for (f, i), t in tbl.items()}
                  for (p, part), tbl in table.items()}
    res = HPCGResult(
        (nx, ny, nz), n, iters, 0.0, 0.0, 0.0,
        D_opt.describe(dispatched=True), valid, rel, flat_table,
        precond=precond, pcg_iters=int(opt.iters), rel_res=float(opt.rel_res),
        bitwise=bitwise, mg_levels=mg_dist.describe() if mg_dist else "", graph=graph,
        conv_graphs=conv)
    if timed:
        _timed_phase(res, _fixed_solve(D_ref, mg_dist, iters),
                     _fixed_solve(D_opt, mg_dist, iters), b_d, reps=reps,
                     eager_reps=eager_reps, graph=graph, device=home)
    if verbose:
        kind = "pcg" if precond else "cg"
        print(f"HPCG-dist {nx}x{ny}x{nz} n={n} parts={nparts} on {home}: "
              f"ref={res.ref_time_s*1e3:.1f}ms opt={res.opt_time_s*1e3:.1f}ms "
              f"speedup={res.speedup:.2f}x {kind}_iters={res.pcg_iters} "
              f"rel_res={res.rel_res:.2e} valid={valid} bitwise={bitwise} "
              f"rel={rel:.2e}")
        _print_graph(res)
        print(f"  per-part: {res.chosen}")
        if res.mg_levels:
            print(f"  levels: {res.mg_levels}")
    return res
