"""BSR SpMM kernel (CUDA) and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/bsr_spmm.py:44`` (``bsr_spmm``)
and, through ``kernels/ops.py``, the reference's bsr/pallas SpMM, SpMV and
masked SpMV. The CUDA source is ``src/repro_torch/csrc/bsr_spmm.cu``; its
header note gives the design and the bound.

The wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises). Both multiply the blocks,
upcast to f32, with X in f32 and return Y in f32. A block id < 0 or >=
nbcols (``ceil(ncols / bs)``) contributes zero, and rows of X past
``ncols`` read as zero: no padded copy of X is made. ``row_mask`` (bool,
``(nbrows * bs,)``) zeroes the rows outside it inside the kernel. At block
edges 16, 32 and 64 with 8 or more columns the kernel multiplies on the
tensor cores in 3xTF32 (:func:`bsr_spmm_path`), else on the CUDA cores with
fused multiply-adds; the plain version sums through a batched matmul, so
the two agree to rounding; two launches give equal bits.

``launches`` on the wrapper counts the kernel launches of this process.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._launch import check_cuda_operands, current_stream, value_code

#: Block edges the kernel is built for: every edge ``to_bsr`` produces
#: (``block_size="auto"`` picks from 64, 32, 16 and 8; the default is 32).
BLOCK_SIZES = (8, 16, 32, 64)


def _shapes(name: str, bcols, blocks, X):
    if bcols.ndim != 2 or blocks.ndim != 4 or X.ndim != 2:
        raise ValueError(f"{name}: bcols (nbrows, bwidth), blocks (nbrows, bwidth, bs, bs) "
                         f"and X (ncols, nf) expected")
    nbrows, bwidth = bcols.shape
    bs = blocks.shape[-1]
    if tuple(blocks.shape) != (nbrows, bwidth, bs, bs):
        raise ValueError(f"{name}: blocks {tuple(blocks.shape)} disagree with bcols "
                         f"{tuple(bcols.shape)}")
    return nbrows, bwidth, bs


def bsr_spmm_plain(bcols: torch.Tensor, blocks: torch.Tensor, X: torch.Tensor,
                   row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`bsr_spmm`: the X block row of each valid
    block gathered, one batched matmul in f32, rows outside ``row_mask``
    zeroed."""
    nbrows, bwidth, bs = _shapes("bsr_spmm_plain", bcols, blocks, X)
    ncols, nf = X.shape
    nbcols = -(-ncols // bs)
    valid = (bcols >= 0) & (bcols < nbcols)
    Xp = torch.zeros((nbcols * bs, nf), dtype=torch.float32, device=X.device)
    Xp[:ncols] = X.float()
    Xg = Xp.reshape(nbcols, bs, nf)[torch.where(valid, bcols, 0).long()]
    Xg = torch.where(valid[..., None, None], Xg, torch.zeros((), device=X.device))
    Y = torch.einsum("rwij,rwjf->rif", blocks.float(), Xg).reshape(nbrows * bs, nf)
    if row_mask is not None:
        Y = torch.where(row_mask[:, None], Y, torch.zeros((), device=Y.device))
    return Y


def bsr_spmm_path(bs: int, nf: int) -> str:
    """Which multiply :func:`bsr_spmm`'s kernel runs at block edge ``bs``
    and ``nf`` columns, as the built kernels decide it: ``"tensor-core"``
    (3xTF32 ``mma.sync``) or ``"cuda-core"``. Needs the kernels' build."""
    from ._build import library

    return "tensor-core" if library().lib.repro_bsr_spmm_tensor_cores(bs, nf) else "cuda-core"


def bsr_spmm(bcols: torch.Tensor, blocks: torch.Tensor, X: torch.Tensor,
             row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Y = A @ X, ``(nbrows * bs, nf)`` f32, for BSR arrays: ``bcols
    (nbrows, bwidth)`` int32 block columns (-1 pads), ``blocks (nbrows,
    bwidth, bs, bs)`` f32/bf16/f16, ``X (ncols, nf)``."""
    if blocks.device.type == "cpu":
        return bsr_spmm_plain(bcols, blocks, X, row_mask)
    nbrows, bwidth, bs = _shapes("bsr_spmm", bcols, blocks, X)
    if bs not in BLOCK_SIZES:
        raise ValueError(f"bsr_spmm: block edge {bs} is not one of {BLOCK_SIZES}")
    if bcols.dtype is not torch.int32:
        raise TypeError(f"bsr_spmm: bcols must be int32, got {bcols.dtype}")
    if row_mask is not None and (row_mask.dtype is not torch.bool
                                 or row_mask.shape != (nbrows * bs,)):
        raise ValueError("bsr_spmm: row_mask must be a bool tensor of shape (nbrows * bs,)")
    ncols, nf = X.shape
    X = X.to(torch.float32).contiguous()
    if X.data_ptr() % 16:  # the kernel stages X with 16-byte copies
        X = X.clone()
    check_cuda_operands("bsr_spmm", bcols, blocks, X, row_mask)
    if blocks.data_ptr() % 16:
        raise ValueError("bsr_spmm: blocks must start on a 16-byte boundary")
    code = value_code("bsr_spmm", blocks.dtype)
    Y = torch.empty((nbrows * bs, nf), dtype=torch.float32, device=blocks.device)
    from ._build import library

    library().call("repro_bsr_spmm", bcols.data_ptr(), blocks.data_ptr(), X.data_ptr(),
                   None if row_mask is None else row_mask.data_ptr(), Y.data_ptr(), nbrows,
                   bwidth, bs, ncols, nf, code, current_stream(blocks.device))
    bsr_spmm.launches += 1
    return Y


bsr_spmm.launches = 0
