"""Format conversions: scipy / dense / container -> container.

Conversions run on the host with numpy and scipy — a one-time setup cost —
and the finished arrays move to ``device`` (default ``"cuda"``; asking for
CUDA without a card raises). The arrays equal those of
``repro.core.convert`` for the same matrix and dtypes.

:func:`from_reference` builds a container from the numpy arrays of a
reference container, so tests can feed both packages the same matrix.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from . import tiling
from .formats import (BSR, COO, CSR, DIA, ELL, SELL, Dense, KernelPlan,
                      format_class, resolve_device, to_tensor)

#: ``col_tile`` convert argument: ``None`` = auto (tile only when the column
#: count exceeds the default resident limit), an int = force that tile
#: width, ``False``/``0`` = never build a column-tile plan.
ColTile = Union[None, int, bool]


def _resolve_col_tile(ncols: int, col_tile: ColTile) -> Optional[int]:
    if col_tile is None:
        return tiling.select_col_tile(ncols)
    if not col_tile:  # False / 0: plans disabled
        return None
    return int(col_tile)


def col_tile_for_policy(fmt: str, ncols: int, ct: Optional[int]) -> ColTile:
    """Map a policy's ``col_tile(ncols)`` decision onto the converter's
    ``col_tile`` argument: ``None`` from the policy means "resident here",
    which for csr/sell is a single-tile SCS plan (the resident kernel's
    layout) and for the other formats no tiled plan at all."""
    if ct is not None:
        return ct
    return max(1, ncols) if fmt in ("csr", "sell") else False


def _as_scipy(a) -> sp.csr_matrix:
    if hasattr(a, "container"):  # SparseOperator facade
        a = a.container
    if sp.issparse(a):
        return a.tocsr()
    if hasattr(a, "to_dense"):  # registered container: the matrix its dense
        s = container_to_scipy(a)  # view gives, built without one
        s.sum_duplicates()
        s.eliminate_zeros()
        return s
    if isinstance(a, torch.Tensor):
        if a.dtype is torch.bfloat16:
            a = a.float()
        a = a.detach().cpu().numpy()
    return sp.csr_matrix(np.asarray(a))


def _as_scipy_sorted(a) -> sp.csr_matrix:
    """Like ``_as_scipy`` but with canonical (sorted) index order, copying
    first when needed so the caller's matrix is never sorted in place."""
    s = _as_scipy(a)
    if not s.has_sorted_indices:
        s = s.copy()
        s.sort_indices()
    return s


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host (bf16 widened to f32, exactly)."""
    t = t.detach().cpu()
    if t.dtype is torch.bfloat16:
        t = t.float()
    return t.numpy()


def from_dense(a, fmt: str, dtype=torch.float32, device="cuda", **kw):
    """Build a container of format ``fmt`` from a dense/scipy matrix."""
    builders = {
        "coo": to_coo, "csr": to_csr, "dia": to_dia, "ell": to_ell,
        "sell": to_sell, "bsr": to_bsr, "dense": to_densefmt,
    }
    return builders[fmt](a, dtype=dtype, device=device, **kw)


def container_to_scipy(c) -> sp.csr_matrix:
    """Container -> scipy CSR without densifying where the format allows:
    COO/CSR carry their triplets directly (pad sentinels dropped); DIA, ELL
    and SELL give their stored nonzeros (the reference densifies these);
    BSR and dense go via ``to_dense``."""
    nrows, ncols = (int(d) for d in c.shape)
    if c.format == "coo":
        row, col, val = (_host(x) for x in (c.row, c.col, c.val))
        keep = row < nrows
        return sp.csr_matrix((val[keep], (row[keep], col[keep])), shape=(nrows, ncols))
    if c.format == "csr":
        indptr = _host(c.indptr)
        nnz = int(indptr[-1])  # trailing entries past indptr[-1] are padding
        return sp.csr_matrix((_host(c.data)[:nnz], _host(c.indices)[:nnz],
                              indptr), shape=(nrows, ncols))
    if c.format in ("dia", "ell", "sell"):
        # the stored entries, padding undone: the matrix the dense route
        # gives, without an (nrows, ncols) array (4.7 TB at HPCG 104^3)
        from .features import _entries_from_container

        row, col, val = _entries_from_container(c)
        s = sp.csr_matrix((val, (row, col)), shape=(nrows, ncols))
        s.eliminate_zeros()
        return s
    return sp.csr_matrix(_host(c.to_dense()))


def convert(A, fmt: str, **kw):
    """Convert between any two containers (exactness only). The result
    stays on ``A``'s device unless ``device=`` says otherwise.

    A same-format conversion *with* build options is a rebuild that keeps
    the instance's recoverable build parameters (SELL ``C``, ELL ``width``,
    BSR ``bs``/``bwidth``) unless overridden."""
    if A.format == fmt:
        if not kw:
            return A
        keep = {"sell": lambda: {"C": A.C},
                "ell": lambda: {"width": A.width},
                "bsr": lambda: {"bs": A.bs, "bwidth": A.bwidth}}.get(fmt)
        if keep is not None:
            kw = {**keep(), **kw}
    kw.setdefault("device", A.device)
    return from_dense(container_to_scipy(A), fmt, dtype=A.dtype, **kw)


def to_densefmt(a, dtype=torch.float32, device="cuda"):
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a.toarray() if sp.issparse(a) else a)
    return Dense(to_tensor(a, dtype, dev), tuple(a.shape))


def to_coo(a, dtype=torch.float32, pad_to: Optional[int] = None,
           col_tile: ColTile = None, index_dtype="auto", device="cuda"):
    dev = resolve_device(device)
    s = _as_scipy(a).tocoo()
    order = np.lexsort((s.col, s.row))  # row-major sort
    row, col, val = s.row[order], s.col[order], s.data[order]
    ct = _resolve_col_tile(s.shape[1], col_tile)
    plan = None
    if ct is not None:
        plan = tiling.plan_to_tensors(
            tiling.build_coo_col_plan(row, col, val.astype(tiling.staging_dtype(dtype)),
                                      tuple(s.shape), ct, index_dtype=index_dtype),
            dtype, dev)
    if len(row) == 0:  # degenerate: keep one zero sentinel entry
        row = np.array([s.shape[0]], np.int32)
        col = np.array([0], np.int32)
        val = np.array([0.0], np.float64)
    if pad_to is not None:
        pad = -len(row) % pad_to
        row = np.concatenate([row, np.full(pad, s.shape[0], np.int32)])
        col = np.concatenate([col, np.zeros(pad, np.int32)])
        val = np.concatenate([val, np.zeros(pad, val.dtype)])
    return COO(to_tensor(row, "int32", dev), to_tensor(col, "int32", dev),
               to_tensor(val, dtype, dev), tuple(s.shape), plan)


def to_csr(a, dtype=torch.float32, col_tile: ColTile = None, plan: bool = True,
           index_dtype="auto", device="cuda"):
    """CSR container; with ``plan=True`` (default) its SELL-C-σ view (the
    ``"scs"`` KernelPlan) rides along for the ``csr``×``cuda`` kernel."""
    dev = resolve_device(device)
    s = _as_scipy_sorted(a)
    scs = None
    if plan and col_tile is not False and col_tile != 0:
        ct = _resolve_col_tile(s.shape[1], col_tile)
        scs = tiling.plan_to_tensors(
            tiling.build_scs_plan(s, col_tile=ct, dtype=dtype,
                                  index_dtype=index_dtype), dtype, dev)
    indices, data = s.indices, s.data
    if len(data) == 0:  # degenerate: one pad entry past indptr[-1]
        indices = np.array([0], np.int32)
        data = np.array([0.0], np.float64)
    return CSR(to_tensor(s.indptr, "int32", dev), to_tensor(indices, "int32", dev),
               to_tensor(data, dtype, dev), tuple(s.shape), scs)


def to_dia(a, dtype=torch.float32, col_tile: ColTile = None, device="cuda"):
    """DIA container. The diagonal fill is vectorised: ``np.add.at`` adds
    every entry in COO order, as the reference's per-entry loop does, so the
    arrays are equal."""
    dev = resolve_device(device)
    s = _as_scipy(a).tocoo()
    nrows, ncols = s.shape
    diag_of = s.col.astype(np.int64) - s.row.astype(np.int64)
    offs = np.unique(diag_of)
    if len(offs) == 0:
        offs = np.array([0], np.int64)
    data = np.zeros((len(offs), nrows), np.float64)
    np.add.at(data, (np.searchsorted(offs, diag_of), s.row), s.data)
    ct = _resolve_col_tile(ncols, col_tile)
    plan = None
    if ct is not None:
        plan = tiling.plan_to_tensors(
            tiling.build_dia_col_plan(offs, data.astype(tiling.staging_dtype(dtype)),
                                      (nrows, ncols), ct), dtype, dev)
    return DIA(to_tensor(offs, "int32", dev), to_tensor(data, dtype, dev),
               (nrows, ncols), plan, extent=int(np.abs(offs).max()))


def _row_entry_positions(take: np.ndarray):
    """For ``take[r]`` entries taken from each row, (j, k) give every taken
    entry's within-row position and its source row's index in ``take``."""
    total = int(take.sum())
    k = np.repeat(np.arange(len(take)), take)
    j = np.arange(total) - np.repeat(np.cumsum(take) - take, take)
    return j, k


def to_ell(a, dtype=torch.float32, width: Optional[int] = None,
           col_tile: ColTile = None, index_dtype="auto", device="cuda"):
    dev = resolve_device(device)
    s = _as_scipy_sorted(a)
    nrows, ncols = s.shape
    counts = np.diff(s.indptr)
    w = int(width if width is not None else (counts.max() if nrows else 0))
    w = max(w, 1)
    idx = np.full((nrows, w), -1, np.int32)
    dat = np.zeros((nrows, w), np.float64)
    j, k = _row_entry_positions(np.minimum(counts, w))
    src = s.indptr[k] + j
    idx[k, j] = s.indices[src]
    dat[k, j] = s.data[src]
    ct = _resolve_col_tile(ncols, col_tile)
    plan = None
    if ct is not None:
        sp_plan = s
        if len(counts) and counts.max() > w:  # width= truncated rows: the plan
            keep = np.zeros(len(s.data), bool)  # must describe the same matrix
            keep[src] = True
            sp_plan = sp.csr_matrix(
                (s.data[keep], s.indices[keep],
                 np.concatenate([[0], np.cumsum(np.minimum(counts, w))])),
                shape=s.shape)
        plan = tiling.plan_to_tensors(
            tiling.build_ell_col_plan(sp_plan, ct, dtype, index_dtype=index_dtype),
            dtype, dev)
    return ELL(to_tensor(idx, "int32", dev), to_tensor(dat, dtype, dev),
               (nrows, ncols), plan)


def to_sell(a, dtype=torch.float32, C: int = 8, sigma: int = 64,
            col_tile: ColTile = None, plan: bool = True, index_dtype="auto",
            device="cuda"):
    """SELL-C-σ container; with ``plan=True`` the ``"scs"`` stream is
    precomputed here."""
    dev = resolve_device(device)
    s = _as_scipy_sorted(a)
    nrows, ncols = s.shape
    counts = np.diff(s.indptr)
    nrows_pad = -(-max(nrows, 1) // C) * C
    perm = np.full(nrows_pad, nrows, np.int32)  # padding rows point past the end
    rows = np.arange(nrows)
    for w0 in range(0, nrows, sigma):  # sigma-window sort by descending nnz
        win = rows[w0 : w0 + sigma]
        perm[w0 : w0 + len(win)] = win[np.argsort(-counts[win], kind="stable")]
    nslices = nrows_pad // C
    counts_pad = np.concatenate([counts, [0]])  # padding rows contribute 0
    widths = np.maximum(counts_pad[perm].reshape(nslices, C).max(axis=1), 1)
    sptr = np.zeros(nslices + 1, np.int64)
    np.cumsum(widths, out=sptr[1:])
    total = int(sptr[-1]) * C
    idx = np.full(total, -1, np.int32)
    dat = np.zeros(total, np.float64)
    real = np.nonzero(perm < nrows)[0]
    rows = perm[real]
    j, k = _row_entry_positions(counts[rows])
    src = s.indptr[rows[k]] + j
    tgt = (sptr[real[k] // C] + j) * C + real[k] % C
    idx[tgt] = s.indices[src]
    dat[tgt] = s.data[src]
    scs = None
    if plan and col_tile is not False and col_tile != 0:
        scs = tiling.plan_to_tensors(
            tiling.build_scs_plan(s, col_tile=_resolve_col_tile(ncols, col_tile),
                                  C=C, sigma=sigma, dtype=dtype,
                                  index_dtype=index_dtype), dtype, dev)
    return SELL(to_tensor(sptr, "int32", dev), to_tensor(idx, "int32", dev),
                to_tensor(dat, dtype, dev), to_tensor(perm, "int32", dev),
                (nrows, ncols), C, scs)


def to_bsr(a, dtype=torch.float32, bs: int = 32, bwidth: Optional[int] = None,
           block_size=None, device="cuda"):
    """Dense/scipy/container -> :class:`BSR` (ELL-of-blocks, ``bcol=-1``
    pads). ``block_size="auto"`` keeps the largest edge of (64, 32, 16, 8)
    whose occupied-block fill is >= 0.5, else the best-fill edge."""
    dev = resolve_device(device)
    s = _as_scipy(a)
    nrows, ncols = s.shape
    if block_size is not None:
        if block_size == "auto":
            from .features import block_density

            coo = s.tocoo()
            fills = {cand: block_density(coo.row, coo.col, nrows, ncols, cand)
                     for cand in (64, 32, 16, 8) if cand <= max(nrows, ncols)}
            if not fills:
                fills = {8: 1.0}
            good = [cand for cand, fill in fills.items() if fill >= 0.5]
            bs = max(good) if good else max(fills, key=fills.get)
        else:
            bs = int(block_size)
    nbrows, nbcols = -(-nrows // bs), -(-ncols // bs)
    b = sp.bsr_matrix(s, blocksize=(bs, bs)) if nrows % bs == 0 and ncols % bs == 0 else None
    if b is None:  # pad then re-block
        pad = sp.csr_matrix((nbrows * bs, nbcols * bs), dtype=s.dtype)
        pad[:nrows, :ncols] = s
        b = sp.bsr_matrix(pad, blocksize=(bs, bs))
    counts = np.diff(b.indptr)
    w = int(bwidth if bwidth is not None else max(1, counts.max() if len(counts) else 1))
    bcols = np.full((nbrows, w), -1, np.int32)
    blocks = np.zeros((nbrows, w, bs, bs), np.float64)
    for br in range(nbrows):
        lo, hi = b.indptr[br], min(b.indptr[br + 1], b.indptr[br] + w)
        bcols[br, : hi - lo] = b.indices[lo:hi]
        blocks[br, : hi - lo] = b.data[lo:hi]
    return BSR(to_tensor(bcols, "int32", dev), to_tensor(blocks, dtype, dev),
               (nrows, ncols))


# ------------------------------------------------- reference containers ----

#: Array fields of each container, in the reference's field order.
_ARRAY_FIELDS = {
    "coo": ("row", "col", "val"), "csr": ("indptr", "indices", "data"),
    "dia": ("offsets", "data"), "ell": ("indices", "data"),
    "sell": ("sptr", "indices", "data", "perm"), "bsr": ("bcols", "blocks"),
    "dense": ("data",),
}


def from_reference(fmt: str, arrays: dict, shape, plan=None, *, device="cuda",
                   **aux):
    """This package's container from a reference container's numpy arrays.

    Args:
        fmt: format name (``"csr"``, ``"dia"``, ...).
        arrays: ``{field: np.ndarray}`` — e.g. ``{"indptr": ..., "indices":
            ..., "data": ...}`` read with ``np.asarray`` from a
            ``repro.core`` container. bf16 arrays (ml_dtypes) keep their
            bit patterns exactly.
        shape: the matrix shape.
        plan: optional ``(kind, arrays, meta)`` of the reference plan.
        device: where the tensors go.
        **aux: non-array fields (DIA ``extent``, SELL ``C``).
    """
    dev = resolve_device(device)
    kw = {name: to_tensor(arrays[name], np.asarray(arrays[name]).dtype.name, dev)
          for name in _ARRAY_FIELDS[fmt]}
    if plan is not None:
        kind, parrays, meta = plan
        kw["plan"] = KernelPlan(
            kind, tuple(to_tensor(a, np.asarray(a).dtype.name, dev) for a in parrays),
            tuple(int(m) for m in meta))
    kw.update(aux)
    return format_class(fmt)(shape=tuple(int(d) for d in shape), **kw)


__all__ = [
    "ColTile", "col_tile_for_policy", "container_to_scipy", "convert",
    "from_dense", "from_reference", "to_bsr", "to_coo", "to_csr",
    "to_densefmt", "to_dia", "to_ell", "to_sell",
]
