"""Column-tiling model + host-side kernel-plan builders.

The numpy plan builders of ``repro.core.tiling``, kept equal array for
array: ``build_scs_plan``, ``build_dia_col_plan``, ``build_ell_col_plan``,
``build_coo_col_plan`` and the index-dtype helpers. A builder returns a
:class:`KernelPlan` of numpy arrays; :func:`plan_to_tensors` moves it to a
device in the container's value dtype.

The ``cuda`` backend keeps the reference's two strategies per format:

  - resident : the kernel reads x whole, from device memory and L2;
  - tiled    : the kernel walks the plan's column tiles, one x tile at a
    time, and accumulates partial y across them.

The choice between them is a column limit, ``max_resident_cols``
(default ``1 << 20``). It is the reference's limit at its defaults, kept so
that both packages build the same plans and pick the same strategy for the
same matrix — a parity setting. No kernel here stages x in shared memory,
so the limit is not a property of the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .formats import KernelPlan, dtype_name, to_tensor

#: Default column limit, shared with ``ExecutionPolicy`` so the policy
#: fields and the convert-time auto-tiling agree on one formula.
DEFAULT_MAX_RESIDENT_COLS = 1 << 20

#: Column-tile geometry caps: at least 8 columns, at most 16k per tile.
MIN_COL_TILE = 8
MAX_COL_TILE = 1 << 14

#: Index dtypes a plan's tile-local column arrays may use, narrowest first.
#: All signed: -1 is the universal pad sentinel, so an index dtype is
#: feasible for a tile of ``ct`` columns iff it can hold ``ct - 1``.
INDEX_DTYPES = ("int8", "int16", "int32")

#: Position of the value array in each plan kind's ``arrays``.
_VALUE_POS = {"ell-cols": 1, "dia-cols": 1, "coo-cols": 2, "scs": 4}


def index_dtype_fits(index_dtype, col_tile: int) -> bool:
    """True when ``index_dtype`` can hold every tile-local column of a
    ``col_tile``-wide tile (ids in ``[0, col_tile)``) plus the -1 pad."""
    if str(index_dtype) == "auto":
        return True
    dt = np.dtype(dtype_name(index_dtype))
    return dt.kind == "i" and int(np.iinfo(dt).max) >= col_tile - 1


def local_index_dtype(col_tile: int, index_dtype="auto") -> np.dtype:
    """The plan-local column-index dtype for a ``col_tile``-wide tile:
    ``"auto"`` picks the narrowest signed dtype holding ``col_tile - 1``;
    an explicit dtype is validated against the tile width."""
    if str(index_dtype) != "auto":
        dt = np.dtype(dtype_name(index_dtype))
        if not index_dtype_fits(dt, col_tile):
            raise ValueError(
                f"index dtype {dt} cannot hold tile-local columns of a "
                f"{col_tile}-wide tile")
        return dt
    for name in INDEX_DTYPES:
        if int(np.iinfo(np.dtype(name)).max) >= col_tile - 1:
            return np.dtype(name)
    return np.dtype(np.int32)


def resident_cols(max_resident_cols: int = DEFAULT_MAX_RESIDENT_COLS) -> int:
    """Columns of x a resident-strategy kernel may take."""
    return int(max_resident_cols)


def select_col_tile(ncols: int,
                    max_resident_cols: int = DEFAULT_MAX_RESIDENT_COLS
                    ) -> Optional[int]:
    """Column-tile size for ``ncols``, or ``None`` when x fits resident:
    half the resident limit, rounded down to 8 and capped at
    ``MAX_COL_TILE`` (the reference's formula)."""
    res = resident_cols(max_resident_cols)
    if ncols <= res:
        return None
    tile = min(res // 2, MAX_COL_TILE)
    return max(MIN_COL_TILE, (tile // 8) * 8)


def staging_dtype(dtype) -> np.dtype:
    """The numpy dtype a builder fills values in before they become
    ``dtype`` tensors: the dtype itself, or f32 for bf16 (which numpy lacks
    and which rounds from f32 as ml_dtypes rounds it)."""
    name = dtype_name(dtype)
    return np.dtype("float32" if name == "bfloat16" else name)


def plan_to_tensors(plan: KernelPlan, value_dtype, device) -> KernelPlan:
    """A numpy-built plan moved to ``device``: the value array in
    ``value_dtype``, every index array in its own (possibly int8/int16)
    dtype."""
    vpos = _VALUE_POS[plan.kind]
    arrays = tuple(
        to_tensor(a, value_dtype if i == vpos else a.dtype.name, device)
        for i, a in enumerate(plan.arrays))
    return KernelPlan(plan.kind, arrays, tuple(int(m) for m in plan.meta))


def _cdiv(a, b):
    """Ceiling division; works elementwise on numpy arrays too."""
    return -(-a // b)


def _cumcount_sorted(group: np.ndarray) -> np.ndarray:
    """Rank of each element within its group, for a non-decreasing group-id
    array (the per-row/per-tile entry position used by every splitter)."""
    n = len(group)
    if n == 0:
        return np.zeros(0, np.int64)
    idx = np.arange(n)
    change = np.r_[True, group[1:] != group[:-1]]
    start = np.maximum.accumulate(np.where(change, idx, 0))
    return idx - start


# ------------------------------------------------------------ ELL splitter ----


def build_ell_col_plan(s, col_tile: int, dtype=np.float32,
                       index_dtype="auto") -> KernelPlan:
    """Split a (sorted) scipy CSR matrix into per-column-tile ELL blocks.

    Arrays: ``idx_t (ntiles, nrows, W)`` tile-local columns (-1 pad) and
    ``dat_t`` alike; ``W`` is the max per-(row, tile) entry count.
    """
    nrows, ncols = s.shape
    ntiles = max(1, _cdiv(ncols, col_tile))
    idt = local_index_dtype(col_tile, index_dtype)
    counts = np.diff(s.indptr)
    r = np.repeat(np.arange(nrows, dtype=np.int64), counts)
    c = s.indices.astype(np.int64)
    t = c // col_tile
    j = _cumcount_sorted(r * ntiles + t)  # CSR order: sorted by (row, col)
    width = int(j.max()) + 1 if len(j) else 1
    idx_t = np.full((ntiles, nrows, width), -1, idt)
    dat_t = np.zeros((ntiles, nrows, width), staging_dtype(dtype))
    idx_t[t, r, j] = (c - t * col_tile).astype(idt)
    dat_t[t, r, j] = s.data
    return KernelPlan("ell-cols", (idx_t, dat_t), (col_tile, ntiles, width))


# ------------------------------------------------------------ DIA splitter ----


def build_dia_col_plan(offsets: np.ndarray, data: np.ndarray,
                       shape: Tuple[int, int], col_tile: int) -> KernelPlan:
    """Split DIA diagonals by the column tiles they cross.

    Row ``i`` of diagonal slot ``(t, d)`` lives at window position
    ``i + off - t*ct``; windows are pre-masked to the tile's columns.
    Arrays: ``offs_t (ntiles, max_d)`` int32 and ``dat_w (ntiles, max_d,
    ct)`` in ``data``'s dtype.
    """
    nrows, ncols = shape
    ntiles = max(1, _cdiv(ncols, col_tile))
    per_tile: list = [[] for _ in range(ntiles)]
    for d, off in enumerate(np.asarray(offsets, np.int64)):
        lo, hi = max(0, -off), min(nrows, ncols - off)
        if lo >= hi:
            continue
        for t in range((lo + off) // col_tile, (hi - 1 + off) // col_tile + 1):
            i0 = max(lo, t * col_tile - off)
            i1 = min(hi, (t + 1) * col_tile - off)
            if i0 < i1:
                per_tile[t].append((int(off), d, i0, i1))
    max_d = max(1, max((len(p) for p in per_tile), default=1))
    offs_t = np.zeros((ntiles, max_d), np.int32)
    dat_w = np.zeros((ntiles, max_d, col_tile), data.dtype)
    for t, diags in enumerate(per_tile):
        for slot, (off, d, i0, i1) in enumerate(diags):
            offs_t[t, slot] = off
            w0 = t * col_tile - off
            dat_w[t, slot, i0 - w0 : i1 - w0] = data[d, i0:i1]
    return KernelPlan("dia-cols", (offs_t, dat_w), (col_tile, ntiles, max_d))


# ------------------------------------------------------------ COO splitter ----


def build_coo_col_plan(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                       shape: Tuple[int, int], col_tile: int,
                       slice_rows: int = 512, tile: int = 512,
                       index_dtype="auto") -> KernelPlan:
    """Sliced-COO layout bucketed by (row slice, column tile).

    Arrays: ``row (B*T,)`` int32 global rows, ``col (B*T,)`` tile-local
    columns, ``val (B*T,)``, ``sid (B,)`` slice id, ``ctile (B,)`` column
    tile of each block.
    """
    nrows, ncols = shape
    ntiles = max(1, _cdiv(ncols, col_tile))
    idt = local_index_dtype(col_tile, index_dtype)
    nsl = max(1, _cdiv(nrows, slice_rows))
    row = np.asarray(row, np.int64)
    keep = row < nrows  # drop (row=nrows,...) pad sentinels
    row, c, v = row[keep], np.asarray(col, np.int64)[keep], np.asarray(val)[keep]
    sl, t = row // slice_rows, c // col_tile
    order = np.lexsort((c, row, t, sl))
    row, c, v, sl, t = row[order], c[order], v[order], sl[order], t[order]

    counts = np.zeros((nsl, ntiles), np.int64)
    np.add.at(counts, (sl, t), 1)
    padded = _cdiv(counts, tile) * tile
    padded[counts.sum(axis=1) == 0, 0] = tile  # empty slice: one zero block
    offsets = np.concatenate([[0], np.cumsum(padded.reshape(-1))])[:-1]
    offsets = offsets.reshape(nsl, ntiles)
    total = int(padded.sum())

    sl_of_group = np.repeat(np.arange(nsl), ntiles)
    row_arr = np.repeat(sl_of_group * slice_rows, padded.reshape(-1)).astype(np.int64)
    col_arr = np.zeros(total, np.int64)
    val_arr = np.zeros(total, v.dtype if len(v) else np.float64)
    rank = _cumcount_sorted(sl * ntiles + t)
    pos = offsets[sl, t] + rank
    row_arr[pos], col_arr[pos], val_arr[pos] = row, c - t * col_tile, v

    blocks = padded.reshape(-1) // tile
    sid = np.repeat(sl_of_group, blocks).astype(np.int32)
    ctile = np.repeat(np.tile(np.arange(ntiles), nsl), blocks).astype(np.int32)
    return KernelPlan(
        "coo-cols",
        (row_arr.astype(np.int32), col_arr.astype(idt), val_arr, sid, ctile),
        (col_tile, ntiles, slice_rows, tile))


# ---------------------------------------------- SELL-C-sigma (SCS) splitter ----


def build_scs_plan(s, col_tile: Optional[int] = None, C: int = 8,
                   sigma: int = 64, slice_window: int = 4,
                   jstep_block: int = 32, dtype=np.float32,
                   index_dtype="auto") -> KernelPlan:
    """SELL-C-σ stream for the csr/sell kernel (``scs_spmv``).

    Rows are permuted by descending nnz inside σ-windows and grouped into
    slices of C lanes; each slice's entries are emitted as j-steps (one
    C-lane vector per within-row position), bucketed by (slice window,
    column tile) — window-major, tile-minor — and each bucket padded to
    ``jstep_block`` j-steps. Empty windows emit one all-padding block.

    Arrays: ``btile (B,)``, ``bwin (B,)`` int32 per block; ``lsl (B*JB,)``
    int32 window-local slice of each j-step; ``idx2/dat2 (B*JB, C)``
    tile-local columns (-1 pad) / values; ``perm (nrows_pad,)`` the
    σ-sorted row permutation. Meta: ``(ct, ntiles, C, sw, jb, nwin)``.
    """
    nrows, ncols = s.shape
    ct = int(col_tile) if col_tile else max(1, ncols)
    ntiles = max(1, _cdiv(max(1, ncols), ct))
    idt = local_index_dtype(ct, index_dtype)
    sw, jb = slice_window, jstep_block
    counts = np.diff(s.indptr)
    nrows_pad = _cdiv(max(nrows, 1), C) * C
    perm = np.full(nrows_pad, nrows, np.int32)
    rows = np.arange(nrows)
    for w0 in range(0, nrows, sigma):
        win = rows[w0:w0 + sigma]
        perm[w0:w0 + len(win)] = win[np.argsort(-counts[win], kind="stable")]
    nslices = nrows_pad // C
    nwin = max(1, _cdiv(nslices, sw))
    nslices_pad = nwin * sw

    pinv = np.zeros(max(nrows, 1), np.int64)
    pinv[perm[perm < nrows]] = np.nonzero(perm < nrows)[0]
    r = np.repeat(np.arange(nrows, dtype=np.int64), counts)
    c = s.indices.astype(np.int64)
    prow = pinv[r]
    sl, lane = prow // C, prow % C
    t = c // ct
    j = _cumcount_sorted(r * ntiles + t)  # within-(row, tile) position

    # per-(slice, tile) width = max over the C lanes of the entry count
    W = np.zeros((nslices_pad, ntiles), np.int64)
    np.maximum.at(W, (sl, t), j + 1)

    nj = W.reshape(nwin, sw, ntiles).sum(axis=1)           # j-steps per (win, tile)
    nj_pad = _cdiv(nj, jb) * jb
    nj_pad[nj_pad.sum(axis=1) == 0, 0] = jb                # empty window: 1 block
    group_off = np.concatenate([[0], np.cumsum(nj_pad.reshape(-1))])[:-1]
    group_off = group_off.reshape(nwin, ntiles)
    Wr = W.reshape(nwin, sw, ntiles)
    pre = np.cumsum(Wr, axis=1) - Wr                       # within-window prefix
    off_sl_t = (group_off[:, None, :] + pre).reshape(nslices_pad, ntiles)

    total_j = int(nj_pad.sum())
    idx2 = np.full((total_j, C), -1, idt)
    dat2 = np.zeros((total_j, C), staging_dtype(dtype))
    jrow = off_sl_t[sl, t] + j
    idx2[jrow, lane] = (c - t * ct).astype(idt)
    dat2[jrow, lane] = s.data

    lsl = np.zeros(total_j, np.int32)
    sl_nz, t_nz = np.nonzero(W)
    lens = W[sl_nz, t_nz]
    starts = off_sl_t[sl_nz, t_nz]
    pos = np.repeat(starts, lens) + _cumcount_sorted(np.repeat(np.arange(len(lens)), lens))
    lsl[pos] = np.repeat(sl_nz % sw, lens).astype(np.int32)

    blocks = nj_pad.reshape(-1) // jb
    bwin = np.repeat(np.repeat(np.arange(nwin), ntiles), blocks).astype(np.int32)
    btile = np.repeat(np.tile(np.arange(ntiles), nwin), blocks).astype(np.int32)
    return KernelPlan("scs", (btile, bwin, lsl, idx2, dat2, perm),
                      (ct, ntiles, C, sw, jb, nwin))


__all__ = [
    "DEFAULT_MAX_RESIDENT_COLS", "INDEX_DTYPES", "MAX_COL_TILE", "MIN_COL_TILE",
    "build_coo_col_plan", "build_dia_col_plan", "build_ell_col_plan",
    "build_scs_plan", "index_dtype_fits", "local_index_dtype",
    "plan_to_tensors", "resident_cols", "select_col_tile", "staging_dtype",
]
