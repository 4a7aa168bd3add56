"""Symmetric Gauss-Seidel (HPCG's smoother) as a SparseOperator client.

The PyTorch counterpart of ``repro.solvers.symgs``, with its two schedules:

  - ``reference``  : textbook forward/backward triangular sweeps in natural
    row order — one row per step, the oracle for small tests;
  - ``multicolor`` : rows greedily colored so no two coupled rows share a
    color; each color updates in parallel as one row-masked SpMV through the
    dispatch table (``SparseOperator.masked_matvec``). A sweep walks the
    colors forward then backward, so the preconditioner stays symmetric.

JAX's ``scan`` over colors (or rows) becomes a Python loop.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core import SparseOperator, as_operator
from repro_torch.core.convert import _as_scipy
from repro_torch.core.formats import resolve_device, to_tensor


def greedy_coloring(s: sp.spmatrix) -> np.ndarray:
    """Greedy distance-1 coloring of the (symmetrised) adjacency of ``s``,
    rows in natural order — the reference's algorithm and colors. The
    27-point stencil colors in 8 (the 2x2x2 parity classes)."""
    s = s.tocsr()
    pattern = ((s != 0) + (s != 0).T).tocsr()  # symmetrise: GS couples both ways
    n = s.shape[0]
    indptr, indices = pattern.indptr.tolist(), pattern.indices.tolist()
    colors = [-1] * n
    for i in range(n):
        used = {colors[j] for j in indices[indptr[i]:indptr[i + 1]]
                if j != i and colors[j] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return np.asarray(colors, np.int32)


def _padded_offdiag(s: sp.csr_matrix) -> Tuple[np.ndarray, np.ndarray]:
    """Strictly off-diagonal entries of each row, ELL-padded (idx=-1, val=0)."""
    s = s.tocsr()
    n = s.shape[0]
    counts = np.diff(s.indptr)
    w = max(1, int(counts.max()) if n else 1)
    idx = np.full((n, w), -1, np.int32)
    val = np.zeros((n, w), np.float64)
    for i in range(n):
        lo, hi = s.indptr[i], s.indptr[i + 1]
        cols, vals = s.indices[lo:hi], s.data[lo:hi]
        off = cols != i
        k = int(off.sum())
        idx[i, :k] = cols[off]
        val[i, :k] = vals[off]
    return idx, val


@dataclass(frozen=True)
class SymGS:
    """One symmetric Gauss-Seidel sweep, ``__call__`` = apply M^-1 from zero.

    ``A`` drives the multicolor path (masked SpMV per color); ``diag`` and
    ``masks`` are host-built schedule data on ``A``'s device. The reference
    path carries the padded off-diagonal arrays instead.
    """

    A: SparseOperator
    diag: torch.Tensor                          # (n,) float
    masks: Optional[torch.Tensor] = None        # (ncolors, n) bool, multicolor only
    off_idx: Optional[torch.Tensor] = None      # (n, w) int64, reference only
    off_val: Optional[torch.Tensor] = None      # (n, w) float, reference only
    method: str = "multicolor"

    @classmethod
    def build(cls, a, operator: Optional[SparseOperator] = None,
              method: str = "multicolor", dtype=torch.float32,
              device="cuda") -> "SymGS":
        """``a`` is anything ``as_operator`` accepts; ``operator`` optionally
        overrides the SpMV operator (its device wins over ``device``)."""
        s = _as_scipy(a).tocsr()
        n = s.shape[0]
        d = np.asarray(s.diagonal(), np.float64)
        if not np.all(d != 0):
            raise ValueError("SymGS needs a nonzero diagonal on every row")
        dev = operator.device if operator is not None else resolve_device(device)
        op = operator if operator is not None else as_operator(s, "csr", device=dev)
        diag = to_tensor(d, dtype, dev)
        if method == "multicolor":
            colors = greedy_coloring(s)
            ncolors = int(colors.max()) + 1 if n else 1
            masks = (np.stack([colors == c for c in range(ncolors)]) if n
                     else np.ones((1, 0), bool))
            return cls(op, diag, masks=torch.from_numpy(masks).to(dev), method=method)
        if method == "reference":
            idx, val = _padded_offdiag(s)
            return cls(op, diag, off_idx=torch.from_numpy(idx).long().to(dev),
                       off_val=to_tensor(val, dtype, dev), method=method)
        raise ValueError(f"unknown SymGS method {method!r}")

    @property
    def ncolors(self) -> int:
        return 0 if self.masks is None else int(self.masks.shape[0])

    def with_operator(self, op: SparseOperator) -> "SymGS":
        """Same schedule, retargeted SpMV operator (per-level tuning hook).

        ``op`` may be any object with the ``masked_matvec(x, mask)``
        protocol — a ``SparseOperator`` or a ``DistributedOperator``."""
        return replace(self, A=op)

    def distribute(self, op) -> "SymGS":
        """This smoother retargeted onto a ``DistributedOperator``.

        Only the ``multicolor`` schedule distributes: each color update is
        one row-masked SpMV (``op.masked_matvec``), which the distributed
        operator runs as local+remote masked SpMV with a fresh halo
        exchange per color — HPCG's multicolored distributed SymGS. The
        schedule (coloring, diagonal) is global data and moves to the
        mesh's home device, where the operator takes and returns vectors;
        the color order is unchanged, so the sweep is the single-device
        multicolor sweep.
        """
        if self.method != "multicolor":
            raise ValueError(
                "only the multicolor schedule distributes (the reference "
                "triangular sweep is a sequential scan over global rows)")
        home = op.mesh.home
        return replace(self, A=op, diag=self.diag.to(home), masks=self.masks.to(home))

    # -- sweeps ---------------------------------------------------------------

    def _color_half(self, r, x, colors):
        for c in colors:
            mask = self.masks[c]
            y = self.A.masked_matvec(x, mask)  # (A x) restricted to the color
            x = torch.where(mask, x + (r - y) / self.diag, x)
        return x

    def _tri_half(self, r, x, reverse: bool):
        x = x.clone()
        rows = range(r.shape[0] - 1, -1, -1) if reverse else range(r.shape[0])
        for i in rows:
            acc = torch.sum(self.off_val[i] * x[self.off_idx[i].clamp(min=0)])  # val=0 at pads
            x[i] = (r[i] - acc) / self.diag[i]
        return x

    def sweep(self, r, x=None) -> torch.Tensor:
        """One symmetric sweep (forward then backward) from iterate ``x``."""
        if x is None:
            x = torch.zeros_like(r)
        if self.method == "multicolor":
            order = range(self.ncolors)
            x = self._color_half(r, x, order)
            return self._color_half(r, x, reversed(order))
        x = self._tri_half(r, x, reverse=False)
        return self._tri_half(r, x, reverse=True)

    def __call__(self, r) -> torch.Tensor:
        """Apply the SymGS preconditioner: M^-1 r (sweep from zero)."""
        return self.sweep(r, torch.zeros_like(r))
