"""ELL SpMV kernels (CUDA) and their plain PyTorch versions.

Replace the TPU kernels ``src/repro/kernels/ell_spmv.py:43`` (``ell_spmv``,
resident x) and ``src/repro/kernels/ell_spmv.py:92`` (``ell_spmv_tiled``,
over the ``"ell-cols"`` plan), and the masked ELL wrapper of
``src/repro/kernels/ops.py:217``. The CUDA source is
``src/repro_torch/csrc/ell_spmv.cu``; its header note gives the design and
the byte bound. One kernel serves both wrappers: it walks, for each chunk
of :data:`CHUNK_ROWS` rows, only the column tiles :func:`ell_tile_index`
lists for it, and ``ell_spmv``'s arrays are a plan of one tile.

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises): there is no fallback from
one to the other. Both accumulate in f32 over f32/bf16/f16 storage and
return y in the storage dtype. A row sums its slots in ascending order with
the multiply and the add rounded apart, and a tiled row adds its tile sums
in ascending tile order, in the kernels and the plain versions alike, so in
f32 they agree exactly. int8/int16 tile-local ids are widened, so they give
the int32 result bit for bit. ``mask`` (bool, ``(nrows,)``) zeroes the rows
outside it inside the kernel: no masked copy of the values is made.

``launches`` on each wrapper counts the kernel launches of this process.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ._launch import (check_cuda_operands, current_stream, index_code, no_grad_operands,
                      value_code)

#: Rows of one chunk of the tiled kernel (one CTA): the granularity of
#: :func:`ell_tile_index` (``kRows`` in ``csrc/ell_spmv.cu``).
CHUNK_ROWS = 128


def _slab_sum(idx: torch.Tensor, data: torch.Tensor, xt: torch.Tensor,
              on: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 sum of each row's slots of one (nrows, W) slab, slot by slot
    in ascending order; ``xt`` is x seen from the slab's first column."""
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=data.device)
    zero = torch.zeros((), device=data.device)
    for k in range(idx.shape[1]):
        c = idx[:, k].long()
        valid = c >= 0 if on is None else (c >= 0) & on
        prod = data[:, k].float() * xt[torch.where(valid, c, 0)]
        acc = acc + torch.where(valid, prod, zero)
    return acc


def _check_mask(name: str, mask, nrows: int) -> None:
    if mask is not None and (mask.dtype is not torch.bool or mask.shape != (nrows,)):
        raise ValueError(f"{name}: mask must be a bool tensor of shape (nrows,)")


def ell_spmv_plain(indices: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`ell_spmv`."""
    return _slab_sum(indices, data, x.float(), mask).to(data.dtype)


def ell_spmv(indices: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             tile_index: Optional["EllTileIndex"] = None) -> torch.Tensor:
    """y = A @ x for ELL arrays: ``indices (nrows, W)`` int32 with -1 pads,
    ``data (nrows, W)``, ``x (ncols,)`` read whole. On the card this is the
    tiled kernel's case of one tile: ``tile_index`` is
    :func:`ell_tile_index` of ``indices[None]``, these very indices seen as
    a plan of one tile, cached by the caller (computed here when omitted);
    an index of another tensor raises ``ValueError``."""
    if tile_index is not None:
        _check_index("ell_spmv", tile_index, indices.unsqueeze(0))
    if data.device.type == "cpu":
        return ell_spmv_plain(indices, data, x, mask)
    nrows, width = data.shape
    if indices.dtype is not torch.int32 or indices.shape != data.shape:
        raise ValueError(f"ell_spmv: indices must be int32 of shape {tuple(data.shape)}, "
                         f"got {indices.dtype} {tuple(indices.shape)}")
    if tile_index is None:
        tile_index = ell_tile_index(indices.unsqueeze(0))
    y = _launch_listed("ell_spmv", indices, data, x, mask, tile_index, nrows, width,
                       x.shape[0])
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0


def ell_spmv_tiled_plain(idx_t: torch.Tensor, dat_t: torch.Tensor, x: torch.Tensor,
                         col_tile: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`ell_spmv_tiled`: per column tile, the f32 sum
    of the tile's slots, added to y in ascending tile order."""
    ntiles, nrows, _ = idx_t.shape
    xf = x.float()
    y = torch.zeros(nrows, dtype=torch.float32, device=dat_t.device)
    for t in range(ntiles):
        y = y + _slab_sum(idx_t[t], dat_t[t], xf[t * col_tile:], mask)
    return y.to(dat_t.dtype)


class EllTileIndex(NamedTuple):
    """What :func:`ell_tile_index` builds: the CSR pair and the plan it
    was built from (``idx_t``'s address, tile count and row count)."""

    tile_ptr: torch.Tensor
    tile_ids: torch.Tensor
    source: tuple


def _plan_key(idx_t: torch.Tensor) -> tuple:
    return (idx_t.data_ptr(), idx_t.device, int(idx_t.shape[0]), int(idx_t.shape[1]))


def ell_tile_index(idx_t: torch.Tensor) -> EllTileIndex:
    """The tiles each chunk of :data:`CHUNK_ROWS` rows of an ``"ell-cols"``
    plan has entries in, as a CSR pair ``(tile_ptr (nchunks + 1,), tile_ids
    (npairs,))``, both int32, tiles ascending inside a chunk: tile ``t`` is
    listed for chunk ``c`` when some slot of ``idx_t[t, c * CHUNK_ROWS :
    (c + 1) * CHUNK_ROWS]`` holds an id >= 0, wherever in the row it lies.
    Built on ``idx_t``'s device, one tile at a time (no temporary of the
    plan's size)."""
    ntiles, nrows, _ = idx_t.shape
    nchunks = -(-nrows // CHUNK_ROWS)
    used = torch.zeros(nchunks * CHUNK_ROWS, ntiles, dtype=torch.bool, device=idx_t.device)
    for t in range(ntiles):
        used[:nrows, t] = (idx_t[t] >= 0).any(-1)
    used = used.view(nchunks, CHUNK_ROWS, ntiles).any(1)
    tile_ptr = torch.zeros(nchunks + 1, dtype=torch.int32, device=idx_t.device)
    tile_ptr[1:] = used.sum(1).cumsum(0)
    return EllTileIndex(tile_ptr, used.nonzero()[:, 1].to(torch.int32), _plan_key(idx_t))


def _check_index(name: str, tile_index, idx_t: torch.Tensor) -> None:
    if not isinstance(tile_index, EllTileIndex) or tile_index.source != _plan_key(idx_t):
        raise ValueError(f"{name}: tile_index must be ell_tile_index of this very "
                         f"index tensor")


def _launch_listed(name, idx, dat, x, mask, tile_index, nrows, width, col_tile):
    """``repro_ell_spmv_listed`` on checked plan arrays: checks the mask and
    ``x``, and that every operand lies on one CUDA device."""
    _check_mask(name, mask, nrows)
    tile_ptr, tile_ids, _ = tile_index
    x = x.to(torch.float32)
    check_cuda_operands(name, idx, dat, x, mask, tile_ptr, tile_ids)
    no_grad_operands(name, dat, x)
    vcode = value_code(name, dat.dtype)
    icode = index_code(name, idx.dtype)
    y = torch.empty(nrows, dtype=dat.dtype, device=dat.device)
    from ._build import library

    library().call("repro_ell_spmv_listed", idx.data_ptr(), dat.data_ptr(), x.data_ptr(),
                   None if mask is None else mask.data_ptr(), tile_ptr.data_ptr(),
                   tile_ids.data_ptr(), y.data_ptr(), nrows, width, col_tile, vcode, icode,
                   current_stream(dat.device))
    return y


def ell_spmv_tiled(idx_t: torch.Tensor, dat_t: torch.Tensor, x: torch.Tensor,
                   col_tile: int, mask: Optional[torch.Tensor] = None,
                   tile_index: Optional[EllTileIndex] = None) -> torch.Tensor:
    """y = A @ x over the ``"ell-cols"`` plan: ``idx_t (ntiles, nrows, W)``
    tile-local ids (int8/int16/int32, -1 pads) and ``dat_t`` alike. An id
    >= 0 always lies inside x, so x is not padded. ``tile_index`` is
    :func:`ell_tile_index` of this very ``idx_t``, cached by the caller
    (computed here when omitted); the kernel reads the plan at the offsets
    it lists, so an index of another tensor raises ``ValueError``."""
    if tile_index is not None:
        _check_index("ell_spmv_tiled", tile_index, idx_t)
    if dat_t.device.type == "cpu":
        return ell_spmv_tiled_plain(idx_t, dat_t, x, col_tile, mask)
    ntiles, nrows, width = dat_t.shape
    if idx_t.shape != dat_t.shape:
        raise ValueError(f"ell_spmv_tiled: idx_t {tuple(idx_t.shape)} and dat_t "
                         f"{tuple(dat_t.shape)} differ")
    if tile_index is None:
        tile_index = ell_tile_index(idx_t)
    y = _launch_listed("ell_spmv_tiled", idx_t, dat_t, x, mask, tile_index, nrows, width,
                       col_tile)
    ell_spmv_tiled.launches += 1
    return y


ell_spmv_tiled.launches = 0
