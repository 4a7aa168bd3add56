"""repro_torch.solvers — the HPCG solve pipeline as SparseOperator clients.

    cg     : fixed-iteration + tolerance-stopping (preconditioned) CG
    symgs  : symmetric Gauss-Seidel smoother (reference triangular sweeps
             and the multicolor masked-SpMV schedule)
    mg     : geometric multigrid V-cycle over re-discretised 27-point
             stencils, with per-level auto-tuned formats
"""
from .cg import (
    CGDiagnostics, CGInfo, as_matvec, axpy, cg, cg_guarded, cg_solve,
    diagnose_cg, pcg_solve, pdot, pnorm,
)
from .symgs import SymGS, greedy_coloring
from .mg import MGLevel, VCycle, build_mg, coarsenable, injection_operators

__all__ = [
    "CGDiagnostics", "CGInfo", "as_matvec", "axpy", "cg", "cg_guarded",
    "cg_solve", "diagnose_cg", "pcg_solve", "pdot", "pnorm",
    "SymGS", "greedy_coloring",
    "MGLevel", "VCycle", "build_mg", "coarsenable", "injection_operators",
]
