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

**Gradients.** On the card, ``bsr_spmm`` called with grad mode on and ``X``
or ``blocks`` requiring grad goes through an autograd function whose
backward runs two kernels of ``src/repro_torch/csrc/bsr_spmm_grad.cu``:
:func:`bsr_spmm_t` (dX = A^T dY) and :func:`bsr_sddmm` (dB = dY X^T at the
stored blocks), each with its plain version beside it and its own launch
count. Both walk one work list, the slots sorted by block column
(:func:`bsr_column_order`, built on the device). ``bsr_spmm_t`` is the
forward with the roles swapped: a CTA owns a block column and a feature
tile and walks the column's run, on the tensor cores in 3xTF32 at block
edges 16, 32 and 64; on the CUDA cores at 8, where a run is cut in chunks
whose partial sums a second kernel adds in chunk order. ``bsr_sddmm``
gives each CTA a chunk of a run, stages the column's X rows once for it and
multiplies the dY rows of its blocks against them on the tensor cores in
3xTF32 (two 8-row blocks to one 16-row tile at bs 8). Each C entry cuts
the runs in its chunks itself, from the list's run bounds, in a scratch
buffer whose size it gives (``repro_bsr_spmm_t_scratch``,
``repro_bsr_sddmm_scratch``).
Nothing is atomic and every sum runs in a fixed order, so two launches
give equal bits. The cast of X to f32 and its alignment copy stay outside
the function, in the graph, so the caller's X gets its gradient in its
dtype; dB comes back in the blocks' dtype, summed in f32. Pad slots and X
rows past ``ncols`` get zero gradients; rows outside ``row_mask`` pass
none. On the CPU autograd runs through the plain version, as it always
has.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ._launch import check_cuda_operands, current_stream, segment_starts, value_code

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


def _on_card(t: torch.Tensor) -> bool:
    """A tensor on a CUDA device: there the wrappers launch their kernels."""
    return t.device.type != "cpu"


def _launch_spmm(bcols, blocks, X, row_mask) -> torch.Tensor:
    """One launch of the forward kernel on checked, f32, aligned ``X``."""
    nbrows, bwidth, bs = blocks.shape[0], blocks.shape[1], blocks.shape[-1]
    ncols, nf = X.shape
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


class _BsrSpmmGrad(torch.autograd.Function):
    """``bsr_spmm``'s kernel with its backward kernels: dX through
    :func:`bsr_spmm_t`, dB through :func:`bsr_sddmm`, each launched only
    for an operand that needs it, over one column-sorted work list."""

    @staticmethod
    def forward(ctx, bcols, blocks, X, row_mask):
        ctx.save_for_backward(bcols, blocks, X, row_mask)
        return _launch_spmm(bcols, blocks, X, row_mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, dY):
        bcols, blocks, X, row_mask = ctx.saved_tensors
        dY = dY.to(torch.float32).contiguous()
        if row_mask is not None:
            dY = torch.where(row_mask[:, None], dY, torch.zeros((), device=dY.device))
        bs = blocks.shape[-1]
        work = bsr_column_order(bcols, -(-X.shape[0] // bs))
        dB = dX = None
        if ctx.needs_input_grad[2]:
            dX = bsr_spmm_t(bcols, blocks, dY, X.shape[0], work)
        if ctx.needs_input_grad[1]:
            dB = bsr_sddmm(bcols, dY, X, bs, work).to(blocks.dtype)
        return None, dB, dX, None


def bsr_spmm(bcols: torch.Tensor, blocks: torch.Tensor, X: torch.Tensor,
             row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Y = A @ X, ``(nbrows * bs, nf)`` f32, for BSR arrays: ``bcols
    (nbrows, bwidth)`` int32 block columns (-1 pads), ``blocks (nbrows,
    bwidth, bs, bs)`` f32/bf16/f16, ``X (ncols, nf)``. Differentiable in
    ``X`` and ``blocks``."""
    if not _on_card(blocks):
        return bsr_spmm_plain(bcols, blocks, X, row_mask)
    nbrows, bwidth, bs = _shapes("bsr_spmm", bcols, blocks, X)
    if bs not in BLOCK_SIZES:
        raise ValueError(f"bsr_spmm: block edge {bs} is not one of {BLOCK_SIZES}")
    if bcols.dtype is not torch.int32:
        raise TypeError(f"bsr_spmm: bcols must be int32, got {bcols.dtype}")
    if row_mask is not None and (row_mask.dtype is not torch.bool
                                 or row_mask.shape != (nbrows * bs,)):
        raise ValueError("bsr_spmm: row_mask must be a bool tensor of shape (nbrows * bs,)")
    X = X.to(torch.float32).contiguous()
    if X.data_ptr() % 16:  # the kernel stages X with 16-byte copies
        X = X.clone()
    if torch.is_grad_enabled() and (X.requires_grad or blocks.requires_grad):
        return _BsrSpmmGrad.apply(bcols, blocks, X, row_mask)
    return _launch_spmm(bcols, blocks, X, row_mask)


bsr_spmm.launches = 0


# ------------------------------------------------------------- backward ----


def bsr_column_order(bcols: torch.Tensor, nbcols: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' work list: ``order (nslots,)`` int32, the
    flat slots ``r * bwidth + w`` sorted stably by block column with every
    pad slot (id < 0 or >= ``nbcols``) last, and ``starts (nbcols + 1,)``
    int32, column ``c``'s run ``[starts[c], starts[c + 1])``. Built on the
    tensors' device with no host read."""
    keys = bcols.reshape(-1).to(torch.int64)
    keys = torch.where((keys >= 0) & (keys < nbcols), keys, torch.full_like(keys, nbcols))
    sorted_keys, order = torch.sort(keys, stable=True)
    return order.to(torch.int32), segment_starts(sorted_keys, nbcols)


def bsr_spmm_t_plain(bcols: torch.Tensor, blocks: torch.Tensor, dY: torch.Tensor,
                     ncols: int) -> torch.Tensor:
    """Plain version of :func:`bsr_spmm_t`: each valid block's ``B^T`` times
    its block row of ``dY`` (one batched matmul in f32), added into its
    block column, rows past ``ncols`` cut."""
    nbrows, bwidth = bcols.shape
    bs = blocks.shape[-1]
    nf = dY.shape[1]
    nbcols = -(-ncols // bs)
    valid = (bcols >= 0) & (bcols < nbcols)
    part = torch.einsum("rwij,rif->rwjf", blocks.float(), dY.float().reshape(nbrows, bs, nf))
    part = torch.where(valid[..., None, None], part, torch.zeros((), device=dY.device))
    dX = torch.zeros((nbcols + 1, bs, nf), dtype=torch.float32, device=dY.device)
    dX.index_add_(0, torch.where(valid, bcols, nbcols).reshape(-1).long(),
                  part.reshape(nbrows * bwidth, bs, nf))
    return dX[:nbcols].reshape(nbcols * bs, nf)[:ncols]


def bsr_sddmm_plain(bcols: torch.Tensor, dY: torch.Tensor, X: torch.Tensor,
                    bs: int) -> torch.Tensor:
    """Plain version of :func:`bsr_sddmm`: ``dY``'s block row times the X
    block row of each valid block, transposed, in f32; zero at pad slots."""
    nbrows, bwidth = bcols.shape
    ncols, nf = X.shape
    nbcols = -(-ncols // bs)
    valid = (bcols >= 0) & (bcols < nbcols)
    Xp = torch.zeros((nbcols * bs, nf), dtype=torch.float32, device=X.device)
    Xp[:ncols] = X.float()
    Xg = Xp.reshape(nbcols, bs, nf)[torch.where(valid, bcols, 0).long()]
    dB = torch.einsum("rif,rwjf->rwij", dY.float().reshape(nbrows, bs, nf), Xg)
    return torch.where(valid[..., None, None], dB, torch.zeros((), device=X.device))


def _work_list(name: str, work, nslots: int, nbcols: int):
    """``work``'s ``(order, starts)`` once their lengths fit the kernels'
    grid: one entry a slot, ``ceil(ncols / bs) + 1`` run bounds."""
    order, starts = work
    if order.shape != (nslots,) or starts.shape != (nbcols + 1,):
        raise ValueError(f"{name}: a work list of {nslots} slots and {nbcols + 1} run bounds "
                         f"(ceil(ncols / bs) + 1) expected, got {tuple(order.shape)} and "
                         f"{tuple(starts.shape)}")
    return order, starts


def _scratch(lib, query: str, *args, device) -> torch.Tensor:
    """The bytes a C entry's ``query`` asks for, uninitialised, on a
    16-byte boundary (the allocator's blocks start on 512)."""
    return torch.empty((getattr(lib.lib, query)(*args),), dtype=torch.uint8, device=device)


def _launch_spmm_t(bcols, blocks, dY, ncols, work) -> torch.Tensor:
    nbrows, bwidth, bs = blocks.shape[0], blocks.shape[1], blocks.shape[-1]
    order, starts = _work_list("bsr_spmm_t", work, nbrows * bwidth, -(-ncols // bs))
    check_cuda_operands("bsr_spmm_t", order, starts, blocks, dY)
    code = value_code("bsr_spmm_t", blocks.dtype)
    if blocks.data_ptr() % 16:  # the kernel stages blocks with 16-byte copies
        blocks = blocks.clone()
    nf, nbcols = dY.shape[1], starts.shape[0] - 1
    dX = torch.empty((ncols, nf), dtype=torch.float32, device=dY.device)
    from ._build import library

    lib = library()
    scratch = _scratch(lib, "repro_bsr_spmm_t_scratch", nbrows * bwidth, nbcols, bs, nf,
                       device=dY.device)
    lib.call("repro_bsr_spmm_t", order.data_ptr(), starts.data_ptr(), blocks.data_ptr(),
             dY.data_ptr(), dX.data_ptr(), scratch.data_ptr(), nbrows * bwidth, nbcols, bwidth,
             bs, ncols, nf, code, current_stream(dY.device))
    bsr_spmm_t.launches += 1
    return dX


def bsr_spmm_t(bcols: torch.Tensor, blocks: torch.Tensor, dY: torch.Tensor, ncols: int,
               work: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """dX = A^T @ dY, ``(ncols, nf)`` f32, for the BSR arrays of
    :func:`bsr_spmm` and ``dY (nbrows * bs, nf)`` f32: the gradient of
    ``bsr_spmm``'s ``X``. ``work`` is :func:`bsr_column_order`'s list (made
    here when not given)."""
    if not _on_card(blocks):
        return bsr_spmm_t_plain(bcols, blocks, dY, ncols)
    nbrows, bs = bcols.shape[0], blocks.shape[-1]
    if (bs not in BLOCK_SIZES or bcols.dtype is not torch.int32
            or tuple(blocks.shape) != (*bcols.shape, bs, bs)):
        raise ValueError(f"bsr_spmm_t: int32 bcols (nbrows, bwidth), blocks (nbrows, bwidth, "
                         f"bs, bs) and a block edge in {BLOCK_SIZES} expected")
    if dY.dtype is not torch.float32 or dY.shape[0] != nbrows * bs:
        raise ValueError(f"bsr_spmm_t: dY must be f32 of {nbrows * bs} rows")
    work = work if work is not None else bsr_column_order(bcols, -(-ncols // bs))
    return _launch_spmm_t(bcols, blocks, dY, ncols, work)


bsr_spmm_t.launches = 0


def _launch_sddmm(bcols, dY, X, bs, work) -> torch.Tensor:
    nbrows, bwidth = bcols.shape
    ncols, nf = X.shape
    order, starts = _work_list("bsr_sddmm", work, nbrows * bwidth, -(-ncols // bs))
    check_cuda_operands("bsr_sddmm", order, starts, dY, X)
    dB = torch.empty((nbrows, bwidth, bs, bs), dtype=torch.float32, device=X.device)
    from ._build import library

    lib = library()
    scratch = _scratch(lib, "repro_bsr_sddmm_scratch", starts.shape[0] - 1, device=X.device)
    lib.call("repro_bsr_sddmm", order.data_ptr(), starts.data_ptr(), dY.data_ptr(),
             X.data_ptr(), dB.data_ptr(), scratch.data_ptr(), nbrows * bwidth, bwidth, bs,
             ncols, nf, current_stream(X.device))
    bsr_sddmm.launches += 1
    return dB


def bsr_sddmm(bcols: torch.Tensor, dY: torch.Tensor, X: torch.Tensor, bs: int,
              work: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """dB, ``(nbrows, bwidth, bs, bs)`` f32: ``dY``'s block row ``r`` times
    X's block row ``bcols[r, w]``, transposed, at every stored block (zero
    at pad slots): the gradient of ``bsr_spmm``'s ``blocks``. ``dY
    (nbrows * bs, nf)`` and ``X (ncols, nf)`` f32."""
    if not _on_card(X):
        return bsr_sddmm_plain(bcols, dY, X, bs)
    nbrows = bcols.shape[0]
    if bs not in BLOCK_SIZES or bcols.dtype is not torch.int32 or bcols.ndim != 2:
        raise ValueError(f"bsr_sddmm: int32 bcols (nbrows, bwidth) and a block edge in "
                         f"{BLOCK_SIZES} expected")
    if (dY.dtype is not torch.float32 or X.dtype is not torch.float32
            or dY.shape != (nbrows * bs, X.shape[1])):
        raise ValueError(f"bsr_sddmm: dY ({nbrows * bs}, nf) and X (ncols, nf) must be f32")
    work = work if work is not None else bsr_column_order(bcols, -(-X.shape[0] // bs))
    return _launch_sddmm(bcols, dY, X, bs, work)


bsr_sddmm.launches = 0
