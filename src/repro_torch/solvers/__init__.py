"""repro_torch.solvers — the HPCG solve pipeline as SparseOperator clients.

    cg     : fixed-iteration + tolerance-stopping (preconditioned) CG, the
             fixed-iteration solve captured in one CUDA graph, and the
             tolerance solve as CUDA graphs with a device-side stop
    symgs  : symmetric Gauss-Seidel smoother (reference triangular sweeps
             and the multicolor masked-SpMV schedule)
    mg     : geometric multigrid V-cycle over re-discretised 27-point
             stencils, with per-level auto-tuned formats, and its
             distributed form over a mesh of parts (``distribute_vcycle``)
"""
from .cg import (
    CG_CHUNK, CapturedCG, CapturedSolve, CGDiagnostics, CGInfo, CGState, as_matvec, axpy, cg,
    cg_chunk, cg_guarded, cg_solve, cg_start, diagnose_cg, pcg_solve, pdot, pnorm,
)
from .symgs import SymGS, greedy_coloring
from .mg import (
    MGLevel, VCycle, build_mg, coarsenable, distributable_depth, distribute_vcycle,
    injection_operators,
)

__all__ = [
    "CG_CHUNK", "CapturedCG", "CapturedSolve", "CGDiagnostics", "CGInfo", "CGState",
    "as_matvec", "axpy", "cg", "cg_chunk", "cg_guarded", "cg_solve", "cg_start",
    "diagnose_cg", "pcg_solve", "pdot", "pnorm",
    "SymGS", "greedy_coloring",
    "MGLevel", "VCycle", "build_mg", "coarsenable", "distributable_depth",
    "distribute_vcycle", "injection_operators",
]
