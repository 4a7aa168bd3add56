"""Structural feature extraction — the zero-run half of format selection.

The paper's Fig. 3 classifies matrices by sparsity structure and shows the
winning format is a *matrix* property; Chen et al. ("Optimizing SpMV on
Emerging Many-Core Architectures") select formats from exactly such features
without ever executing a kernel. This module computes those features from any
registered container (or scipy/dense input) **entirely host-side with
numpy**: no kernel dispatch, no device work beyond reading the container's
arrays back — what makes zero-run format selection possible. This is the
numpy module of ``repro.core.features``, kept equal to it; only the reading
of tensor fields is new.

Features are defined on the matrix's *logical nonzeros* (stored entries with
a nonzero value), so all five sparse containers of the same matrix — whose
padding schemes differ — report identical features; the property suite
checks that invariant too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

#: Block edge used for the ``block_density`` feature (small against every
#: container's tile geometry so the feature describes the *matrix*, not a
#: kernel layout).
FEATURE_BLOCK = 8

#: Block edge of the BSR builder's default tile — ``block_density32`` is the
#: same statistic at this edge, and is what the BSR cost/feasibility rows in
#: ``core.select`` consume: 1/block_density32 is exactly BSR's storage
#: blow-up factor at its own granularity.
BSR_FEATURE_BLOCK = 32

#: A column counts as "dense" when it holds at least this fraction of rows.
DENSE_COL_FILL = 0.5


@dataclass(frozen=True)
class MatrixFeatures:
    """The paper-aligned structural features of one sparse matrix.

    Row-permutation behaviour (asserted by the property suite): the
    ``rownnz_*`` statistics, ``density`` and ``dense_cols`` are invariant
    under row permutation (they depend only on the multiset of row lengths
    and on column fills); ``ndiags``, ``diag_fill``, ``band_extent`` and
    ``block_density`` are *positional* and may change.
    """

    nrows: int
    ncols: int
    nnz: int              # logical nonzeros (padding excluded)
    density: float        # nnz / (nrows * ncols)
    rownnz_mean: float    # nnz-per-row mean
    rownnz_std: float     # nnz-per-row standard deviation
    rownnz_var: float     # nnz-per-row variance (std**2, kept explicit)
    rownnz_max: int       # longest row
    ndiags: int           # distinct occupied diagonals
    diag_fill: float      # nnz / (ndiags * nrows): fill of occupied diagonals
    band_extent: int      # max |col - row| over nonzeros
    block_density: float  # nnz / (occupied FEATURE_BLOCK^2 blocks * block area)
    dense_cols: int       # columns with fill >= DENSE_COL_FILL
    # nnz / occupied area at BSR's native 32-edge blocks; defaulted so older
    # positional constructions (zero-matrix paths) stay valid
    block_density32: float = 0.0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def rownnz_imbalance(self) -> float:
        """``rownnz_max / max(rownnz_mean, 1)`` — ELL's padding blow-up factor
        (the quantity ``structural_skip`` guards on)."""
        return self.rownnz_max / max(self.rownnz_mean, 1.0)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def _np(a) -> np.ndarray:
    """A container field on the host as numpy (bf16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype is torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _entries_from_container(c):
    """(row, col, val) numpy triplets of a registered container, host-side.

    Each format's padding scheme is undone here (COO row sentinels, CSR
    entries past ``indptr[-1]``, DIA out-of-range cells, ELL/SELL ``-1``
    column sentinels) so every container of the same matrix yields the same
    logical entry set.
    """
    nrows, ncols = (int(d) for d in c.shape)
    fmt = c.format
    if fmt == "coo":
        row, col, val = (_np(a) for a in (c.row, c.col, c.val))
        keep = row < nrows
        return row[keep], col[keep], val[keep]
    if fmt == "csr":
        indptr = _np(c.indptr)
        nnz = int(indptr[-1])  # trailing entries are padding
        row = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
        return row, _np(c.indices)[:nnz], _np(c.data)[:nnz]
    if fmt == "dia":
        offsets = _np(c.offsets).astype(np.int64)
        data = _np(c.data)
        d, i = np.nonzero(data)  # zero cells are DIA padding by construction
        col = i + offsets[d]
        keep = (col >= 0) & (col < ncols)
        return i[keep], col[keep], data[d[keep], i[keep]]
    if fmt == "ell":
        idx = _np(c.indices)
        dat = _np(c.data)
        r, j = np.nonzero(idx >= 0)
        return r, idx[r, j], dat[r, j]
    if fmt == "sell":
        sptr = _np(c.sptr).astype(np.int64)
        idx = _np(c.indices)
        dat = _np(c.data)
        perm = _np(c.perm)
        C = int(c.C)
        e = np.arange(idx.shape[0], dtype=np.int64)
        base = sptr * C
        s = np.searchsorted(base, e, side="right") - 1
        lane = (e - base[s]) % C
        row = perm[s * C + lane]
        keep = (idx >= 0) & (row < nrows)
        return row[keep], idx[keep], dat[keep]
    if fmt == "bsr":
        bcols = _np(c.bcols)
        blocks = _np(c.blocks)
        bs = int(blocks.shape[-1])
        br, j, bi, bj = np.nonzero(blocks)
        bc = bcols[br, j]
        keep = bc >= 0
        row = br[keep] * bs + bi[keep]
        col = bc[keep] * bs + bj[keep]
        inside = (row < nrows) & (col < ncols)
        return row[inside], col[inside], blocks[br, j, bi, bj][keep][inside]
    if fmt == "dense":
        r, col = np.nonzero(_np(c.data))
        return r, col, _np(c.data)[r, col]
    raise TypeError(f"cannot extract entries from format {fmt!r}")


def _to_entries(a):
    """(row, col, val, shape) of anything matrix-like, on the host."""
    import scipy.sparse as sp

    if hasattr(a, "container"):  # SparseOperator facade
        a = a.container
    if sp.issparse(a):
        coo = a.tocoo(copy=True)
        coo.sum_duplicates()  # duplicates would inflate the row stats the
        # structural-guard mirror shares with the (dedup-seeing) tuner
        return (np.asarray(coo.row), np.asarray(coo.col),
                np.asarray(coo.data), tuple(int(d) for d in a.shape))
    if getattr(type(a), "format", None) is not None and hasattr(a, "shape"):
        row, col, val = _entries_from_container(a)
        return row, col, val, tuple(int(d) for d in a.shape)
    d = _np(a)
    if d.ndim != 2:
        raise TypeError(f"expected a matrix, got ndim={d.ndim}")
    r, c = np.nonzero(d)
    return r, c, d[r, c], tuple(int(x) for x in d.shape)


def extract_features(a) -> MatrixFeatures:
    """Structural features of ``a`` (container, operator, scipy, or dense).

    Pure numpy — extraction executes no kernel and triggers no jit trace,
    so it is safe inside zero-run paths like ``tune(mode="predict")``.

    Example:
        >>> import scipy.sparse as sp
        >>> f = extract_features(sp.eye(8, format="csr"))
        >>> (f.nnz, f.ndiags, f.band_extent, f.rownnz_max)
        (8, 1, 0, 1)
        >>> round(f.diag_fill, 2)
        1.0
    """
    row, col, val, (nrows, ncols) = _to_entries(a)
    keep = val != 0
    row = row[keep].astype(np.int64)
    col = col[keep].astype(np.int64)
    nnz = int(row.shape[0])

    if nnz == 0:
        return MatrixFeatures(nrows, ncols, 0, 0.0, 0.0, 0.0, 0.0, 0, 0,
                              0.0, 0, 0.0, 0)

    counts = np.bincount(row, minlength=max(nrows, 1)).astype(np.float64)
    counts.sort()  # canonical order: row-length stats are *bit-exact* under
    # row permutation (summation order would otherwise leak last-bit noise)
    diags = col - row
    ndiags = int(np.unique(diags).shape[0])
    colcounts = np.bincount(col, minlength=max(ncols, 1))
    return MatrixFeatures(
        nrows=nrows,
        ncols=ncols,
        nnz=nnz,
        density=nnz / float(max(nrows * ncols, 1)),
        rownnz_mean=float(counts.mean()),
        rownnz_std=float(counts.std()),
        rownnz_var=float(counts.var()),
        rownnz_max=int(counts.max()),
        ndiags=ndiags,
        diag_fill=nnz / float(max(ndiags * nrows, 1)),
        band_extent=int(np.abs(diags).max()),
        block_density=block_density(row, col, nrows, ncols, FEATURE_BLOCK),
        dense_cols=int((colcounts >= DENSE_COL_FILL * max(nrows, 1)).sum()),
        block_density32=block_density(row, col, nrows, ncols,
                                      BSR_FEATURE_BLOCK),
    )


def block_density(row, col, nrows: int, ncols: int, bs: int) -> float:
    """``nnz / occupied area`` at ``bs``-edge blocks, from entry coordinates.

    Shared by :func:`extract_features` (bs=8 and bs=32 fields) and the
    structural-guard mirror in ``core.autotune.structural_skip`` so the
    selector and the tuner judge block fill with bit-identical arithmetic.
    """
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    if row.shape[0] == 0:
        return 0.0
    nblockcols = -(-ncols // bs)
    blocks = np.unique((row // bs) * nblockcols + col // bs)
    # occupied area clips edge blocks to the matrix boundary — a ragged
    # dimension must not inflate the denominator (a dense 4x4 is 1.0 dense,
    # not 4x4/8x8 = 0.25)
    b_r, b_c = blocks // nblockcols, blocks % nblockcols
    b_h = np.minimum(bs, nrows - b_r * bs)
    b_w = np.minimum(bs, ncols - b_c * bs)
    return row.shape[0] / float((b_h * b_w).sum())
