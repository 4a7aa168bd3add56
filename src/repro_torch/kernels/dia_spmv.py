"""DIA SpMV kernels (CUDA) and their plain PyTorch versions.

Replace the TPU kernels ``src/repro/kernels/dia_spmv.py:58`` (``dia_spmv``,
resident x) and ``src/repro/kernels/dia_spmv.py:135`` (``dia_spmv_tiled``,
over the ``"dia-cols"`` plan). The CUDA sources are
``src/repro_torch/csrc/dia_spmv.cu``; their header note gives the design
and the byte bound.

The dispatch table calls :func:`dia_spmv_from_container`, which checks a
container's arrays once and keeps the result in its ``cache``, and gives a
masked call on many rows the list of the mask's rows (:func:`dia_row_list`,
cached too), so that the kernel's warps run only rows the mask keeps; and,
on the ``"dia-cols"`` plan, :func:`dia_spmv_tiled_from_plan`, which checks
the plan once and keeps it, with its offset range, in ``plan.cache``.

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises): there is no fallback from
one to the other. Both accumulate in f32 over f32/bf16/f16 storage and
return y in the storage dtype — the contract of ``ops._precision_ok``. In
f32 the kernels and the plain versions add the same products in the same
order, so they agree exactly.

``launches`` on each wrapper counts the kernel launches of this process;
``dia_spmv.by_shape`` splits them by ``(nrows, masked)``.
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

from ._launch import check_cuda_operands, checked_x, current_stream, no_grad_operands, value_code

#: Shared memory holds the offsets: 48 KB of int32 without opting in to more.
MAX_RESIDENT_DIAGS = 12288


def dia_spmv_plain(offsets: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`dia_spmv`: diagonal by diagonal, each row's
    in-range products added to an f32 sum, y cast to ``data.dtype``."""
    nrows = data.shape[1]
    ncols = x.shape[0]
    xf = x.float()
    acc = torch.zeros(nrows, dtype=torch.float32, device=data.device)
    for d, off in enumerate(offsets.tolist()):
        lo, hi = max(0, -off), min(nrows, ncols - off)
        if lo < hi:
            acc[lo:hi] = acc[lo:hi] + data[d, lo:hi].float() * xf[lo + off:hi + off]
    if mask is not None:
        acc = torch.where(mask, acc, torch.zeros((), device=acc.device))
    return acc.to(data.dtype)


class DiaRowList(NamedTuple):
    """The rows a row mask keeps, ascending, int32 on the mask's device
    (``rows``), and the mask it was built from: ``source`` is its address,
    device and length, ``mask`` the tensor itself (held, so that its memory
    is not reused while the list lives) and ``version`` its count of
    in-place writes when the list was built."""

    rows: torch.Tensor
    source: tuple
    mask: torch.Tensor
    version: int


def _mask_key(mask: torch.Tensor) -> tuple:
    return (mask.data_ptr(), mask.device, mask.numel())


def dia_row_list(mask: torch.Tensor) -> DiaRowList:
    """The list of ``mask``'s rows that the masked kernel walks instead of
    every row (built on the mask's device; it waits for the device once,
    to learn the count)."""
    return DiaRowList(torch.nonzero(mask).flatten().to(torch.int32), _mask_key(mask), mask,
                      mask._version)


def _check_rows(rows: DiaRowList, mask: Optional[torch.Tensor]) -> None:
    if (not isinstance(rows, DiaRowList) or mask is None
            or rows.source != _mask_key(mask) or rows.version != mask._version):
        raise ValueError("dia_spmv: rows must be dia_row_list of this very mask, built "
                         "since its last in-place write")


#: Row lists a container keeps, one per mask, the oldest dropped first.
MAX_ROW_LISTS = 16
#: Rows from which a masked call walks the mask's row list: it is 15-20%
#: faster at HPCG 52^3 (140,608 rows) and 104^3, 1-4% slower at 26^3
#: (17,576) and 13^3, where one more dependent load shows in a launch of
#: about 3 us (examples/dia_kernel_ab.py, PERF.md, PR 16).
LIST_MIN_ROWS = 1 << 16


def _cached_rows(cache: dict, mask: torch.Tensor) -> DiaRowList:
    """``mask``'s row list from ``cache``, built on first sight and again
    after an in-place write to the mask."""
    lists = cache.setdefault("rows", {})
    key = _mask_key(mask)
    got = lists.get(key)
    if got is None or got.version != mask._version:
        if got is None and len(lists) >= MAX_ROW_LISTS:
            del lists[next(iter(lists))]
        got = lists[key] = dia_row_list(mask)
    return got


class _Resident(NamedTuple):
    """What the first launch on a pair of resident arrays checked and keeps:
    the arrays, their addresses and sizes, the value code and the
    library's entries (whole or masked; over a row list)."""

    offsets: torch.Tensor
    data: torch.Tensor
    ptrs: Tuple[int, int]
    ndiags: int
    nrows: int
    code: int
    device: torch.device
    lib: object
    entry: object
    listed: object


def _resident(offsets: torch.Tensor, data: torch.Tensor) -> _Resident:
    """Check resident DIA arrays on the card in full (raise on what the
    kernel does not take) and keep what the launches need."""
    ndiags, nrows = data.shape
    if offsets.dtype is not torch.int32 or offsets.shape != (ndiags,):
        raise ValueError(f"dia_spmv: offsets must be int32 of shape ({ndiags},), "
                         f"got {offsets.dtype} {tuple(offsets.shape)}")
    if ndiags > MAX_RESIDENT_DIAGS:
        raise ValueError(f"dia_spmv: {ndiags} diagonals exceed the kernel's "
                         f"{MAX_RESIDENT_DIAGS}")
    check_cuda_operands("dia_spmv", offsets, data)
    code = value_code("dia_spmv", data.dtype)
    from ._build import library

    lib = library()
    return _Resident(offsets, data, (offsets.data_ptr(), data.data_ptr()), ndiags, nrows,
                     code, data.device, lib, lib.lib.repro_dia_spmv,
                     lib.lib.repro_dia_spmv_listed)


def _checked_x(r: _Resident | _Tiled, x: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` in f32, once it and ``mask`` have been checked against ``r``."""
    x = checked_x("dia_spmv", x, r.device)
    dev = r.device
    if mask is not None and (mask.dtype is not torch.bool or mask.shape != (r.nrows,)
                             or mask.device != dev or not mask.is_contiguous()):
        raise ValueError(f"dia_spmv: mask must be a contiguous bool tensor of shape "
                         f"({r.nrows},) on {dev}")
    return x


def _launch(r: _Resident, x: torch.Tensor, mask: Optional[torch.Tensor],
            rows: Optional[DiaRowList]) -> torch.Tensor:
    """The kernel's launch on checked operands: over ``rows`` when given,
    else over every row (the masked-out ones written 0)."""
    no_grad_operands("dia_spmv", r.data, x)
    dev = r.device
    y = torch.empty(r.nrows, dtype=r.data.dtype, device=dev)
    mp = None if mask is None else mask.data_ptr()
    if rows is None:
        code = r.entry(r.ptrs[0], r.ptrs[1], x.data_ptr(), mp, y.data_ptr(), r.ndiags,
                       r.nrows, x.shape[0], r.code, current_stream(dev))
    else:
        code = r.listed(r.ptrs[0], r.ptrs[1], x.data_ptr(), mp, rows.rows.data_ptr(),
                        rows.rows.shape[0], y.data_ptr(), r.ndiags, r.nrows, x.shape[0],
                        r.code, current_stream(dev))
    r.lib.check("repro_dia_spmv" if rows is None else "repro_dia_spmv_listed", code)
    dia_spmv.launches += 1
    dia_spmv.by_shape[(r.nrows, mask is not None)] += 1
    return y


def dia_spmv(offsets: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             rows: Optional[DiaRowList] = None) -> torch.Tensor:
    """y = A @ x for DIA arrays (``offsets (ndiags,)`` int32, ``data
    (ndiags, nrows)``, ``x (ncols,)``), x read whole. ``mask`` (bool,
    ``(nrows,)``) zeroes the rows outside it and skips their work;
    ``rows``, :func:`dia_row_list` of this very mask, has the kernel walk
    only the mask's rows (a list of another mask, or one built before the
    mask's last in-place write, raises ``ValueError``)."""
    if rows is not None:
        _check_rows(rows, mask)
    if data.device.type == "cpu":
        return dia_spmv_plain(offsets, data, x, mask)
    r = _resident(offsets, data)
    return _launch(r, _checked_x(r, x, mask), mask, rows)


#: Launches of this process, and of each ``(nrows, masked)`` among them.
dia_spmv.launches = 0
dia_spmv.by_shape = Counter()


def dia_spmv_from_container(A, x: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch-table adapter: :func:`dia_spmv` on a DIA container. The
    first call on the card checks ``A``'s arrays in full and keeps the
    result in ``A.cache``; later calls check only ``x`` and ``mask``. A
    masked call on :data:`LIST_MIN_ROWS` rows or more walks the mask's row
    list, kept in ``A.cache`` too (the last :data:`MAX_ROW_LISTS` masks)."""
    r = A.cache.get("resident")
    if r is None:
        if A.data.device.type == "cpu":
            return dia_spmv_plain(A.offsets, A.data, x, mask)
        r = A.cache["resident"] = _resident(A.offsets, A.data)
    x = _checked_x(r, x, mask)
    rows = None
    if mask is not None and r.nrows >= LIST_MIN_ROWS:
        rows = _cached_rows(A.cache, mask)
    return _launch(r, x, mask, rows)


def dia_spmv_tiled_plain(offs_t: torch.Tensor, dat_w: torch.Tensor, x: torch.Tensor,
                         nrows: int, col_tile: int,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`dia_spmv_tiled`: per column tile, the f32 sum
    of the tile's diagonal slots (in slot order) over the rows the tile's
    band reaches, added to y in ascending tile order."""
    ntiles, max_d, ct = dat_w.shape
    if ct != col_tile:
        raise ValueError(f"dia_spmv_tiled: windows of {ct} columns, tile {col_tile}")
    ncols = x.shape[0]
    xf = x.float()
    offs = offs_t.tolist()
    y = torch.zeros(nrows, dtype=torch.float32, device=dat_w.device)
    for t in range(ntiles):
        r0 = max(0, t * ct - max(offs[t]))
        r1 = min(nrows, (t + 1) * ct - min(offs[t]))
        if r0 >= r1:
            continue
        acc = torch.zeros(r1 - r0, dtype=torch.float32, device=dat_w.device)
        for d, off in enumerate(offs[t]):
            a = max(r0, t * ct - off)
            b = min(r1, (t + 1) * ct - off, ncols - off)
            if a >= b:
                continue
            p0 = a + off - t * ct
            acc[a - r0:b - r0] = (acc[a - r0:b - r0]
                                  + dat_w[t, d, p0:p0 + (b - a)].float() * xf[a + off:b + off])
        y[r0:r1] = y[r0:r1] + acc
    if mask is not None:
        y = torch.where(mask, y, torch.zeros((), device=y.device))
    return y.to(dat_w.dtype)


class _Tiled(NamedTuple):
    """What the first launch on a ``"dia-cols"`` plan checked and keeps: the
    arrays, their addresses, the plan's geometry and offset range, the
    value code and the library's entry."""

    offs_t: torch.Tensor
    dat_w: torch.Tensor
    ptrs: Tuple[int, int]
    ntiles: int
    max_d: int
    ct: int
    nrows: int
    lo: int
    hi: int
    code: int
    device: torch.device
    lib: object
    entry: object


def _tiled(offs_t: torch.Tensor, dat_w: torch.Tensor, nrows: int, col_tile: int) -> _Tiled:
    """Check a ``"dia-cols"`` plan on the card in full (raise on what the
    kernel does not take), read its offset range (one wait for the device)
    and keep what the launches need."""
    ntiles, max_d, ct = dat_w.shape
    if ct != col_tile or offs_t.dtype is not torch.int32 or offs_t.shape != (ntiles, max_d):
        raise ValueError(f"dia_spmv_tiled: offs_t must be int32 ({ntiles}, {max_d}) "
                         f"and dat_w's last dim the column tile {col_tile}")
    if max_d > MAX_RESIDENT_DIAGS:
        raise ValueError(f"dia_spmv_tiled: {max_d} slots a tile exceed the kernel's "
                         f"{MAX_RESIDENT_DIAGS}")
    check_cuda_operands("dia_spmv_tiled", offs_t, dat_w)
    code = value_code("dia_spmv_tiled", dat_w.dtype)
    lo, hi = int(offs_t.min()), int(offs_t.max())
    from ._build import library

    lib = library()
    return _Tiled(offs_t, dat_w, (offs_t.data_ptr(), dat_w.data_ptr()), ntiles, max_d, ct,
                  nrows, lo, hi, code, dat_w.device, lib, lib.lib.repro_dia_spmv_tiled)


def _launch_tiled(r: _Tiled, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The tiled kernel's launch on checked operands."""
    no_grad_operands("dia_spmv_tiled", r.dat_w, x)
    dev = r.device
    y = torch.empty(r.nrows, dtype=r.dat_w.dtype, device=dev)
    code = r.entry(r.ptrs[0], r.ptrs[1], x.data_ptr(), None if mask is None else mask.data_ptr(),
                   y.data_ptr(), r.ntiles, r.max_d, r.ct, r.nrows, x.shape[0], r.lo, r.hi,
                   r.code, current_stream(dev))
    r.lib.check("repro_dia_spmv_tiled", code)
    dia_spmv_tiled.launches += 1
    return y


def dia_spmv_tiled(offs_t: torch.Tensor, dat_w: torch.Tensor, x: torch.Tensor,
                   nrows: int, col_tile: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A @ x over the ``"dia-cols"`` plan: ``offs_t (ntiles, max_d)``
    int32 offsets and ``dat_w (ntiles, max_d, ct)`` diagonal windows.
    Checks the plan on every call; :func:`dia_spmv_tiled_from_plan` checks
    it once."""
    if dat_w.device.type == "cpu":
        return dia_spmv_tiled_plain(offs_t, dat_w, x, nrows, col_tile, mask)
    r = _tiled(offs_t, dat_w, nrows, col_tile)
    return _launch_tiled(r, _checked_x(r, x, mask), mask)


dia_spmv_tiled.launches = 0


def dia_spmv_tiled_from_plan(plan, x: torch.Tensor, nrows: int,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch-table adapter: :func:`dia_spmv_tiled` on a ``"dia-cols"``
    plan of ``nrows`` rows. The first call on the card checks the plan in
    full, reads its offset range and keeps both in ``plan.cache``; later
    calls check only ``x`` and ``mask``."""
    offs_t, dat_w = plan.arrays
    r = plan.cache.get("tiled")
    if r is None:
        if dat_w.device.type == "cpu":
            return dia_spmv_tiled_plain(offs_t, dat_w, x, nrows, plan.ct, mask)
        r = plan.cache["tiled"] = _tiled(offs_t, dat_w, nrows, plan.ct)
    elif r.nrows != nrows:
        raise ValueError(f"dia_spmv_tiled: the plan was checked for {r.nrows} rows, "
                         f"called with {nrows}")
    return _launch_tiled(r, _checked_x(r, x, mask), mask)
