"""Geometric multigrid V-cycle for the HPCG 27-point stencil.

The PyTorch counterpart of ``repro.solvers.mg``: at every level pre-smooth
with SymGS, restrict the residual by injection onto the 2x-coarsened grid,
recurse, prolong the coarse correction back, post-smooth. Coarse operators
are re-discretised 27-point stencils. Every linear piece is a
``SparseOperator``: the level matrices (tunable per level) and the
restriction/prolongation maps (COO operators on the default plain policy).
The distributed variant waits for ROADMAP queue 1, item 8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core import SparseOperator, as_operator
from repro_torch.core import matrices as M
from repro_torch.core.autotune import autotune_spmv

from .symgs import SymGS


def injection_operators(nx: int, ny: int, nz: int, dtype=torch.float32,
                        device="cuda") -> Tuple[SparseOperator, SparseOperator]:
    """(R, P) for one 2x geometric coarsening step, as COO SparseOperators:
    R[ic, f2c[ic]] = 1 (injection) and P = R^T."""
    f2c = M.coarsen_injection(nx, ny, nz)
    nf, nc = nx * ny * nz, len(f2c)
    ones = np.ones(nc, np.float64)
    R = sp.csr_matrix((ones, (np.arange(nc), f2c)), shape=(nc, nf))
    P = sp.csr_matrix((ones, (f2c, np.arange(nc))), shape=(nf, nc))
    return (as_operator(R, "coo", dtype=dtype, device=device),
            as_operator(P, "coo", dtype=dtype, device=device))


@dataclass(frozen=True)
class MGLevel:
    grid: Tuple[int, int, int]
    A: SparseOperator
    smoother: SymGS
    R: Optional[SparseOperator] = None  # to the next (coarser) level
    P: Optional[SparseOperator] = None  # back from it

    @property
    def chosen(self) -> str:
        pol = self.A.policy
        backend = pol.backends[0] if pol is not None and pol.backends else "plain"
        return f"{self.A.format}/{backend}"


@dataclass(frozen=True)
class VCycle:
    """Recursive V-cycle, ``__call__(r) ~= A^-1 r`` — a symmetric positive-
    definite preconditioner when pre == post."""

    levels: Tuple[MGLevel, ...]
    pre: int = 1
    post: int = 1
    coarse_sweeps: int = 4

    @property
    def depth(self) -> int:
        return len(self.levels)

    def describe(self) -> str:
        return " | ".join(f"{'x'.join(map(str, l.grid))}:{l.chosen}"
                          for l in self.levels)

    def retuned(self, candidates=None, mode: str = "run") -> "VCycle":
        """Retarget every level's operator to a fresh (format, backend)
        choice raced by the run-first tuner (Table III). Schedules and R/P
        are reused. ``mode="predict"`` needs the zero-run selector (ROADMAP
        queue 1, item 4) and raises."""
        if mode == "predict":
            raise NotImplementedError(
                "retuned(mode='predict') needs the zero-run selector, not ported "
                "yet (ROADMAP queue 1, item 4: core/select.py)")
        if mode != "run":
            raise ValueError(f"retuned mode {mode!r}: expected 'run' or 'predict'")
        levels = []
        for l in self.levels:
            op = autotune_spmv(l.A, candidates=candidates, device=l.A.device).operator
            levels.append(MGLevel(l.grid, op, l.smoother.with_operator(op),
                                  l.R, l.P))
        return VCycle(tuple(levels), self.pre, self.post, self.coarse_sweeps)

    def _apply(self, li: int, r: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[li]
        x = torch.zeros_like(r)
        if li == len(self.levels) - 1:  # coarsest: smooth it out
            for _ in range(self.coarse_sweeps):
                x = lvl.smoother.sweep(r, x)
            return x
        for _ in range(self.pre):
            x = lvl.smoother.sweep(r, x)
        res = r - lvl.A @ x
        xc = self._apply(li + 1, lvl.R @ res)
        x = x + lvl.P @ xc
        for _ in range(self.post):
            x = lvl.smoother.sweep(r, x)
        return x

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self._apply(0, r)


def coarsenable(grid: Sequence[int], min_dim: int = 4) -> bool:
    """Whether a stencil grid admits another 2x geometric coarsening step.

    Example:
        >>> coarsenable((8, 8, 8)), coarsenable((8, 8, 7)), coarsenable((2, 2, 2))
        (True, False, False)
    """
    return all(d % 2 == 0 and d // 2 >= min_dim // 2 and d > 2 for d in grid)


def build_mg(nx: int, ny: int, nz: int, *, depth: int = 4, pre: int = 1,
             post: int = 1, coarse_sweeps: int = 4, fmt: str = "csr",
             method: str = "multicolor", tune: bool = False,
             candidates=None, dtype=torch.float32, device="cuda") -> VCycle:
    """Build the HPCG multigrid hierarchy for an (nx, ny, nz) stencil grid
    on ``device``: ``depth`` caps the levels, coarsening stops early when a
    dim goes odd or too small; ``tune=True`` races ``candidates`` on every
    level. ``fmt`` is the level format when not tuning."""
    levels = []
    grid = (nx, ny, nz)
    for li in range(depth):
        A_sp = M.fdm27(*grid)
        op = as_operator(A_sp, fmt, device=device).using("plain")
        smoother = SymGS.build(A_sp, operator=op, method=method, dtype=dtype)
        last = li == depth - 1 or not coarsenable(grid)
        R = P = None
        if not last:
            R, P = injection_operators(*grid, dtype=dtype, device=device)
        levels.append(MGLevel(grid, op, smoother, R, P))
        if last:
            break
        grid = tuple(d // 2 for d in grid)
    vc = VCycle(tuple(levels), pre=pre, post=post, coarse_sweeps=coarse_sweeps)
    return vc.retuned(candidates) if tune else vc
