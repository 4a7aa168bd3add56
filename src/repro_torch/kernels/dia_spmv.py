"""DIA SpMV kernels (CUDA) and their plain PyTorch versions.

Replace the TPU kernels ``src/repro/kernels/dia_spmv.py:58`` (``dia_spmv``,
resident x) and ``src/repro/kernels/dia_spmv.py:135`` (``dia_spmv_tiled``,
over the ``"dia-cols"`` plan). The CUDA sources are
``src/repro_torch/csrc/dia_spmv.cu``; their header note gives the design
and the byte bound.

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises): there is no fallback from
one to the other. Both accumulate in f32 over f32/bf16/f16 storage and
return y in the storage dtype — the contract of ``ops._precision_ok``. In
f32 the kernels and the plain versions add the same products in the same
order, so they agree exactly.

``launches`` on each wrapper counts the kernel launches of this process.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._launch import check_cuda_operands, current_stream, value_code

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


def dia_spmv(offsets: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A @ x for DIA arrays (``offsets (ndiags,)`` int32, ``data
    (ndiags, nrows)``, ``x (ncols,)``), x read whole. ``mask`` (bool,
    ``(nrows,)``) zeroes the rows outside it and skips their work."""
    if data.device.type == "cpu":
        return dia_spmv_plain(offsets, data, x, mask)
    ndiags, nrows = data.shape
    if offsets.dtype is not torch.int32 or offsets.shape != (ndiags,):
        raise ValueError(f"dia_spmv: offsets must be int32 of shape ({ndiags},), "
                         f"got {offsets.dtype} {tuple(offsets.shape)}")
    if ndiags > MAX_RESIDENT_DIAGS:
        raise ValueError(f"dia_spmv: {ndiags} diagonals exceed the kernel's "
                         f"{MAX_RESIDENT_DIAGS}")
    if mask is not None and (mask.dtype is not torch.bool or mask.shape != (nrows,)):
        raise ValueError("dia_spmv: mask must be a bool tensor of shape (nrows,)")
    x = x.to(torch.float32)
    check_cuda_operands("dia_spmv", offsets, data, x, mask)
    code = value_code("dia_spmv", data.dtype)
    y = torch.empty(nrows, dtype=data.dtype, device=data.device)
    from ._build import library

    library().call("repro_dia_spmv", offsets.data_ptr(), data.data_ptr(),
                   x.data_ptr(), None if mask is None else mask.data_ptr(),
                   y.data_ptr(), ndiags, nrows, x.shape[0], code,
                   current_stream(data.device))
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0


def _offset_range(offs_t: torch.Tensor) -> Tuple[int, int]:
    return int(offs_t.min()), int(offs_t.max())


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


def dia_spmv_tiled(offs_t: torch.Tensor, dat_w: torch.Tensor, x: torch.Tensor,
                   nrows: int, col_tile: int, mask: Optional[torch.Tensor] = None,
                   offset_range: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """y = A @ x over the ``"dia-cols"`` plan: ``offs_t (ntiles, max_d)``
    int32 offsets and ``dat_w (ntiles, max_d, ct)`` diagonal windows.
    ``offset_range`` is ``(min, max)`` of ``offs_t`` when the caller has it
    cached (else it is read from the device)."""
    if dat_w.device.type == "cpu":
        return dia_spmv_tiled_plain(offs_t, dat_w, x, nrows, col_tile, mask)
    ntiles, max_d, ct = dat_w.shape
    if ct != col_tile or offs_t.dtype is not torch.int32 or offs_t.shape != (ntiles, max_d):
        raise ValueError(f"dia_spmv_tiled: offs_t must be int32 ({ntiles}, {max_d}) "
                         f"and dat_w's last dim the column tile {col_tile}")
    if mask is not None and (mask.dtype is not torch.bool or mask.shape != (nrows,)):
        raise ValueError("dia_spmv_tiled: mask must be a bool tensor of shape (nrows,)")
    x = x.to(torch.float32)
    check_cuda_operands("dia_spmv_tiled", offs_t, dat_w, x, mask)
    code = value_code("dia_spmv_tiled", dat_w.dtype)
    lo, hi = offset_range if offset_range is not None else _offset_range(offs_t)
    y = torch.empty(nrows, dtype=dat_w.dtype, device=dat_w.device)
    from ._build import library

    library().call("repro_dia_spmv_tiled", offs_t.data_ptr(), dat_w.data_ptr(),
                   x.data_ptr(), None if mask is None else mask.data_ptr(),
                   y.data_ptr(), ntiles, max_d, ct, nrows, x.shape[0], lo, hi,
                   code, current_stream(dat_w.device))
    dia_spmv_tiled.launches += 1
    return y


dia_spmv_tiled.launches = 0
