"""COO SpMV kernels (CUDA) and their plain PyTorch versions.

Replace the TPU kernels ``src/repro/kernels/coo_spmv.py:85`` (``coo_spmv``,
the full window over row-sorted entries), ``src/repro/kernels/coo_spmv.py:141``
(``scoo_spmv``, sliced over the :func:`build_scoo` layout) and
``src/repro/kernels/coo_spmv.py:200`` (``scoo_spmv_tiled``, over the
``"coo-cols"`` plan). The CUDA source is ``src/repro_torch/csrc/coo_spmv.cu``;
its header note gives the design and the byte bound. ``scoo_spmv`` runs the
device code of ``scoo_spmv_tiled`` with global column ids and no column
tiles.

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises). Both accumulate in f32 over
f32/bf16/f16 storage and return y in the storage dtype, without float
atomics, so two launches give equal bits. ``coo_spmv`` sums each row's
entries in entry order, as its plain version does, so in f32 the two agree
exactly; ``scoo_spmv`` and ``scoo_spmv_tiled`` split each slice across the
warps of one CTA and combine same-row products with a warp scan and the
warps' windows in warp order, so they agree with their plain versions to
rounding. int8/int16 tile-local ids give the int32 result bit for bit.

The dispatch table calls :func:`coo_spmv_from_container` for the full
window, which checks a container's arrays once and keeps them, with their
segment starts, in its ``cache``.

``launches`` on each wrapper counts the kernel launches of this process.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ._launch import (check_cuda_operands, checked_x, current_stream, index_code,
                      segment_starts, value_code)

#: Slice rows the sliced kernel holds in shared memory: one window of f32
#: per warp of the slice's CTA, eight warps up to 1536 rows and four at
#: 3072, within the 48 KB a CTA gets without opting in to more.
MAX_SLICE_ROWS = 3072


def coo_spmv_plain(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   x: torch.Tensor, nrows: int) -> torch.Tensor:
    """Plain version of :func:`coo_spmv`: each row's products added to an
    f32 sum one entry at a time, in entry order."""
    starts = segment_starts(row, nrows).long()
    lens = starts[1:] - starts[:-1]
    prod = val.float() * x.float()[col.long()]
    acc = torch.zeros(nrows, dtype=torch.float32, device=val.device)
    zero = torch.zeros((), device=val.device)
    last = max(prod.shape[0] - 1, 0)
    for k in range(int(lens.max()) if nrows else 0):
        take = (starts[:-1] + k).clamp(max=last)
        acc = acc + torch.where(k < lens, prod[take], zero)
    return acc.to(val.dtype)


class _Rows(NamedTuple):
    """What the first full-window launch on a set of COO arrays checked and
    keeps: the arrays and their segment starts, their addresses, the row
    count, the value code and the library's entry."""

    row_start: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    ptrs: Tuple[int, int, int]
    nrows: int
    code: int
    device: torch.device
    lib: object
    entry: object


def _rows(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor, nrows: int) -> _Rows:
    """Check row-sorted COO arrays on the card in full (raise on what the
    kernel does not take), find their segment starts and keep what the
    launches need."""
    for name, t in (("row", row), ("col", col)):
        if t.dtype is not torch.int32 or t.shape != val.shape:
            raise ValueError(f"coo_spmv: {name} must be int32 of shape {tuple(val.shape)}")
    check_cuda_operands("coo_spmv", row, col, val)
    row_start = segment_starts(row, nrows)
    code = value_code("coo_spmv", val.dtype)
    from ._build import library

    lib = library()
    return _Rows(row_start, col, val, (row_start.data_ptr(), col.data_ptr(), val.data_ptr()),
                 nrows, code, val.device, lib, lib.lib.repro_coo_spmv)


def _launch_rows(r: _Rows, x: torch.Tensor) -> torch.Tensor:
    """The full-window launch on the checked record ``r``; ``x`` is checked
    here."""
    x = checked_x("coo_spmv", x, r.device)
    dev = r.device
    y = torch.empty(r.nrows, dtype=r.val.dtype, device=dev)
    code = r.entry(r.ptrs[0], r.ptrs[1], r.ptrs[2], x.data_ptr(), y.data_ptr(), r.nrows,
                   x.shape[0], r.code, current_stream(dev))
    r.lib.check("repro_coo_spmv", code)
    coo_spmv.launches += 1
    return y


def coo_spmv(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor, x: torch.Tensor,
             nrows: int) -> torch.Tensor:
    """y = A @ x for row-sorted COO arrays (``row``/``col`` int32, tail
    sentinels ``row == nrows`` dropped). Checks the arrays and finds their
    segment starts on every call; :func:`coo_spmv_from_container` does so
    once."""
    if val.device.type == "cpu":
        return coo_spmv_plain(row, col, val, x, nrows)
    return _launch_rows(_rows(row, col, val, nrows), x)


coo_spmv.launches = 0


def coo_spmv_from_container(A, x: torch.Tensor) -> torch.Tensor:
    """Dispatch-table adapter: :func:`coo_spmv` on a COO container. The
    first call on the card checks ``A``'s arrays in full, finds their
    segment starts and keeps both in ``A.cache``; later calls check only
    ``x``."""
    r = A.cache.get("rows")
    if r is None:
        if A.val.device.type == "cpu":
            return coo_spmv_plain(A.row, A.col, A.val, x, A.shape[0])
        r = A.cache["rows"] = _rows(A.row, A.col, A.val, A.shape[0])
    return _launch_rows(r, x)


def scoo_spmv_tiled_plain(row, col, val, sid, ctile, x, *, nrows: int, col_tile: int,
                          tile: int) -> torch.Tensor:
    """Plain version of :func:`scoo_spmv_tiled`: every entry's product
    (tile-local id offset by its block's column tile), summed per row."""
    dev = val.device
    xf = x.float()
    gcol = ctile.long().repeat_interleave(tile) * col_tile + col.long()
    prod = val.float() * xf[gcol.clamp(max=xf.shape[0] - 1)]
    prod = torch.where(gcol < xf.shape[0], prod, torch.zeros((), device=dev))
    return _row_sums(row, prod, nrows).to(val.dtype)


def _row_sums(row: torch.Tensor, prod: torch.Tensor, nrows: int) -> torch.Tensor:
    """Each row's products summed, whatever the order of the entries."""
    order = torch.argsort(row, stable=True)
    lengths = torch.bincount(row.long(), minlength=nrows)
    return torch.segment_reduce(prod[order], "sum", lengths=lengths)


def scoo_spmv_tiled(row, col, val, sid, ctile, x, *, nrows: int, col_tile: int,
                    slice_rows: int, tile: int, run_start=None) -> torch.Tensor:
    """y = A @ x over a ``build_coo_col_plan`` layout.

    Args:
        row: (B*tile,) int32 global rows, grouped by slice, then by
            column tile (each block holds one tile's entries), in any order
            inside a block.
        col: (B*tile,) tile-local columns (int8/int16/int32).
        val: (B*tile,) values.
        sid/ctile: (B,) int32 slice and column tile of each block.
        x: (ncols,) dense vector.
        col_tile/slice_rows/tile: the plan's geometry (``plan.meta``).
        run_start: the cached :func:`segment_starts` of ``sid`` over the
            slices (computed here when omitted).
    """
    if val.device.type == "cpu":
        return scoo_spmv_tiled_plain(row, col, val, sid, ctile, x, nrows=nrows,
                                     col_tile=col_tile, tile=tile)
    nblocks = sid.shape[0]
    if row.shape != (nblocks * tile,) or col.shape != row.shape or val.shape != row.shape:
        raise ValueError("scoo_spmv_tiled: row/col/val disagree with (B * tile,)")
    for name, t in (("row", row), ("sid", sid), ("ctile", ctile)):
        if t.dtype is not torch.int32:
            raise TypeError(f"scoo_spmv_tiled: {name} must be int32, got {t.dtype}")
    if not 0 < slice_rows <= MAX_SLICE_ROWS:
        raise ValueError(f"scoo_spmv_tiled: slice_rows {slice_rows} outside "
                         f"(0, {MAX_SLICE_ROWS}]")
    nslices = -(-nrows // slice_rows)
    if run_start is None:
        run_start = segment_starts(sid, nslices)
    x = x.to(torch.float32)
    check_cuda_operands("scoo_spmv_tiled", row, col, val, ctile, run_start, x)
    vcode = value_code("scoo_spmv_tiled", val.dtype)
    icode = index_code("scoo_spmv_tiled", col.dtype)
    y = torch.empty(nrows, dtype=val.dtype, device=val.device)
    from ._build import library

    library().call("repro_scoo_spmv_tiled", row.data_ptr(), col.data_ptr(), val.data_ptr(),
                   ctile.data_ptr(), run_start.data_ptr(), x.data_ptr(), y.data_ptr(),
                   nslices, tile, slice_rows, col_tile, nrows, x.shape[0], vcode, icode,
                   current_stream(val.device))
    scoo_spmv_tiled.launches += 1
    return y


scoo_spmv_tiled.launches = 0


def build_scoo(row, col, val, nrows: int, slice_rows: int = 512, tile: int = 512):
    """Host-side SCOO (sliced COO) layout: entries bucketed by row slice,
    each slice padded to a multiple of ``tile`` with entries on its first
    row and value 0 (an empty slice gets one whole tile of them), so each
    block of ``tile`` entries touches one slice.

    The arrays of ``repro.kernels.coo_spmv.build_scoo``, equal in value,
    dtype and order: ``(row int32, col int32, val, slice_ids int32)``. One
    stable sort by slice keeps each slice's entries in input order.
    """
    row, col, val = np.asarray(row), np.asarray(col), np.asarray(val)
    keep = (row >= 0) & (row < nrows)  # the reference's slices hold no others
    row, col, val = row[keep], col[keep], val[keep]
    nsl = -(-nrows // slice_rows)
    sl = row.astype(np.int64) // slice_rows
    order = np.argsort(sl, kind="stable")
    counts = np.bincount(sl, minlength=nsl)
    padded = np.where(counts > 0, -(-counts // tile) * tile, tile)
    start = np.cumsum(padded) - padded
    first = np.cumsum(counts) - counts
    dest = start[sl[order]] + (np.arange(order.shape[0]) - first[sl[order]])
    out_row = np.repeat((np.arange(nsl) * slice_rows).astype(row.dtype), padded)
    out_col = np.zeros(int(padded.sum()), col.dtype)
    out_val = np.zeros(int(padded.sum()), val.dtype)
    out_row[dest], out_col[dest], out_val[dest] = row[order], col[order], val[order]
    sids = np.repeat(np.arange(nsl), padded // tile)
    return (out_row.astype(np.int32), out_col.astype(np.int32), out_val,
            sids.astype(np.int32))


def scoo_spmv_plain(row, col, val, slice_ids, x, *, nrows: int) -> torch.Tensor:
    """Plain version of :func:`scoo_spmv`: every entry's product, summed
    per row (pad entries add 0 to their slice's first row)."""
    xf = x.float()
    c = col.long()
    prod = val.float() * xf[c.clamp(0, max(xf.shape[0] - 1, 0))]
    inside = (c >= 0) & (c < xf.shape[0])
    prod = torch.where(inside, prod, torch.zeros((), device=val.device))
    return _row_sums(row, prod, nrows).to(val.dtype)


def scoo_spmv(row, col, val, slice_ids, x, *, nrows: int, slice_rows: int = 512,
              tile: int = 512, run_start=None) -> torch.Tensor:
    """y = A @ x over a :func:`build_scoo` layout.

    Args:
        row/col: (B*tile,) int32 global rows and columns, grouped by
            slice, in any order inside a slice.
        val: (B*tile,) values.
        slice_ids: (B,) int32 slice of each block, ascending.
        x: (ncols,) dense vector; columns outside it read as zero.
        slice_rows/tile: the layout's geometry.
        run_start: the cached :func:`segment_starts` of ``slice_ids`` over
            the slices (computed here when omitted).
    """
    if val.device.type == "cpu":
        return scoo_spmv_plain(row, col, val, slice_ids, x, nrows=nrows)
    nblocks = slice_ids.shape[0]
    if row.shape != (nblocks * tile,) or col.shape != row.shape or val.shape != row.shape:
        raise ValueError("scoo_spmv: row/col/val disagree with (B * tile,)")
    for name, t in (("row", row), ("col", col), ("slice_ids", slice_ids)):
        if t.dtype is not torch.int32:
            raise TypeError(f"scoo_spmv: {name} must be int32, got {t.dtype}")
    if not 0 < slice_rows <= MAX_SLICE_ROWS:
        raise ValueError(f"scoo_spmv: slice_rows {slice_rows} outside (0, {MAX_SLICE_ROWS}]")
    nslices = -(-nrows // slice_rows)
    if run_start is None:
        run_start = segment_starts(slice_ids, nslices)
    x = x.to(torch.float32)
    check_cuda_operands("scoo_spmv", row, col, val, run_start, x)
    vcode = value_code("scoo_spmv", val.dtype)
    y = torch.empty(nrows, dtype=val.dtype, device=val.device)
    from ._build import library

    library().call("repro_scoo_spmv", row.data_ptr(), col.data_ptr(), val.data_ptr(),
                   run_start.data_ptr(), x.data_ptr(), y.data_ptr(), nslices, tile,
                   slice_rows, nrows, x.shape[0], vcode, current_stream(val.device))
    scoo_spmv.launches += 1
    return y


scoo_spmv.launches = 0
