"""SELL-C-σ SpMV kernel (CUDA) over the ``"scs"`` plan, and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/sell_spmv.py:64``
(``scs_spmv``), which serves both ``csr`` and ``sell`` through the SELL-C-σ
view each container carries from convert time. The CUDA source is
``src/repro_torch/csrc/sell_spmv.cu``; its header note gives the design and
the byte bound. One warp takes one chunk of at most a few consecutive
blocks of one output window (:func:`scs_work_list`) and reads only each
block's real j-steps (:func:`scs_real_jsteps`); a window of several chunks
gets its partial sums added in a fixed order by a second kernel in the
same launch call. No float atomics: the result is the same on every run.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device (or raises). Values accumulate in f32
over f32/bf16/f16 storage; int8/int16 tile-local indices are widened in the
kernel, so they give the bit-identical result of int32. y comes back in the
storage dtype.

``scs_spmv.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ._launch import (check_cuda_operands, current_stream, index_code, no_grad_operands,
                      segment_starts, value_code)

#: Slices per window the kernel takes (csrc/sell_spmv.cu: a lane owns at
#: most 8 rows of a window).
MAX_SLICE_WINDOW = 8
#: Blocks per chunk of the work list at most (an A/B of 4, 8, 16 and 32 in
#: examples/scs_kernel_ab.py chose 8); a chunk's blocks are a warp's lanes,
#: so the kernel takes at most 32.
CHUNK_BLOCKS = 8


def scs_spmv_plain(btile, bwin, lsl, idx2, dat2, perm, x, *, nrows: int,
                   col_tile: int, ntiles: int, C: int, sw: int, jb: int,
                   nwin: int) -> torch.Tensor:
    """Plain version of :func:`scs_spmv`, in the reference's terms: each
    block's products summed per window-local slice (the one-hot
    contraction), block sums added per window in block order, then
    un-permuted."""
    nblocks = btile.shape[0]
    dev = dat2.device
    xp = torch.zeros(ntiles * col_tile, dtype=torch.float32, device=dev)
    xp[: x.shape[0]] = x.float()
    valid = idx2 >= 0
    cols = (btile.long().repeat_interleave(jb)[:, None] * col_tile
            + idx2.long().clamp(min=0))
    prod = torch.where(valid, dat2.float() * xp[cols],
                       torch.zeros((), device=dev))                 # (B*jb, C)
    onehot = (lsl.view(nblocks, jb, 1)
              == torch.arange(sw, device=dev, dtype=lsl.dtype)).float()
    contrib = torch.einsum("bjs,bjc->bsc", onehot, prod.view(nblocks, jb, C))
    per_win = torch.bincount(bwin.long(), minlength=nwin)
    y2 = torch.segment_reduce(contrib.reshape(nblocks, sw * C), "sum",
                              lengths=per_win)                      # (nwin, sw*C)
    yp = y2.reshape(-1)[: perm.shape[0]]
    y = torch.zeros(nrows + 1, dtype=torch.float32, device=dev)
    y[perm.long().clamp(max=nrows)] = yp
    return y[:nrows].to(dat2.dtype)


class ScsWorkList(NamedTuple):
    """The chunks :func:`scs_spmv`'s kernel walks, one warp each: chunk
    ``c`` is blocks ``[chunk_block[c], chunk_block[c + 1])`` of window
    ``chunk_win[c]``, at most ``chunk_blocks`` of them; window ``w`` owns
    chunks ``[win_chunk[w], win_chunk[w + 1])`` (at least one, so every
    window's rows are written); ``split_win`` lists the windows of more than
    one chunk, whose partials a second pass adds. ``nblocks`` and ``nwin``
    record the plan it was built for."""

    chunk_block: torch.Tensor
    chunk_win: torch.Tensor
    win_chunk: torch.Tensor
    split_win: torch.Tensor
    chunk_blocks: int
    nblocks: int
    nwin: int


def scs_work_list(run_start: torch.Tensor, chunk_blocks: int = CHUNK_BLOCKS) -> ScsWorkList:
    """Cut each window's run of blocks (``run_start``, from
    :func:`segment_starts`) into chunks of at most ``chunk_blocks``
    consecutive blocks, on ``run_start``'s device."""
    if not 1 <= chunk_blocks <= 32:
        raise ValueError(f"scs_work_list: chunk_blocks must lie in [1, 32], got {chunk_blocks}")
    rs = run_start.long()
    nwin = rs.shape[0] - 1
    nblk = rs[1:] - rs[:-1]
    nch = torch.clamp((nblk + chunk_blocks - 1) // chunk_blocks, min=1)
    win_chunk = torch.zeros(nwin + 1, dtype=torch.long, device=rs.device)
    torch.cumsum(nch, 0, out=win_chunk[1:])
    nchunks = int(win_chunk[-1])
    chunk_win = torch.repeat_interleave(torch.arange(nwin, device=rs.device), nch,
                                        output_size=nchunks)
    k = torch.arange(nchunks, device=rs.device) - win_chunk[chunk_win]
    first = torch.minimum(rs[chunk_win] + k * chunk_blocks, rs[chunk_win + 1])
    chunk_block = torch.cat([first, rs[-1:]])
    split_win = torch.nonzero(nch > 1).flatten()
    return ScsWorkList(chunk_block.int(), chunk_win.int(), win_chunk.int(), split_win.int(),
                       chunk_blocks, int(rs[-1]), nwin)


def scs_real_jsteps(idx2: torch.Tensor, jb: int) -> torch.Tensor:
    """``(B,)`` int32: the j-steps of each block that hold an entry. A j-step
    is real when one of its C ids is >= 0; the plan pads each (window, tile)
    bucket with a suffix of all -1 j-steps, so the real ones are a prefix
    of the block and the kernel stops after them."""
    return (idx2.view(-1, jb, idx2.shape[1]) >= 0).any(-1).sum(-1).to(torch.int32)


def scs_spmv(btile, bwin, lsl, idx2, dat2, perm, x, *, nrows: int,
             col_tile: int, ntiles: int, C: int, sw: int, jb: int, nwin: int,
             nreal=None, work: Optional[ScsWorkList] = None) -> torch.Tensor:
    """y = A @ x over a ``build_scs_plan`` SELL-C-σ stream.

    Args:
        btile/bwin: (B,) int32 per-block column tile / output window.
        lsl: (B*jb,) int32 window-local slice of each j-step.
        idx2/dat2: (B*jb, C) tile-local columns (-1 pad) / values.
        perm: (nrows_pad,) σ-sorted row permutation (pad rows = nrows).
        x: (ncols,) dense vector.
        nreal: the cached :func:`scs_real_jsteps` of ``idx2``.
        work: the cached :func:`scs_work_list` of the plan's window runs.
        Both are computed here when omitted.

    The kernel copies each block with 16-byte loads, so it takes ``jb`` a
    multiple of 16 and ``idx2``, ``dat2`` and ``lsl`` starting on 16-byte
    boundaries; other plans raise ``ValueError`` on the card.

    Returns (nrows,) in original row order, in ``dat2``'s dtype.
    """
    if dat2.device.type == "cpu":
        return scs_spmv_plain(btile, bwin, lsl, idx2, dat2, perm, x, nrows=nrows,
                              col_tile=col_tile, ntiles=ntiles, C=C, sw=sw,
                              jb=jb, nwin=nwin)
    if C <= 0 or C > 32 or 32 % C or not 0 < sw <= MAX_SLICE_WINDOW or jb % 16:
        raise ValueError(f"scs_spmv: the kernel takes C dividing 32, at most "
                         f"{MAX_SLICE_WINDOW} slices per window and jb a multiple of 16, "
                         f"got C={C} sw={sw} jb={jb}")
    nblocks = btile.shape[0]
    if idx2.shape != (nblocks * jb, C) or dat2.shape != idx2.shape \
            or lsl.shape != (nblocks * jb,):
        raise ValueError("scs_spmv: plan arrays disagree with (B, jb, C)")
    for name, t in (("btile", btile), ("bwin", bwin), ("lsl", lsl), ("perm", perm)):
        if t.dtype is not torch.int32:
            raise TypeError(f"scs_spmv: {name} must be int32, got {t.dtype}")
    if idx2.data_ptr() % 16 or dat2.data_ptr() % 16 or lsl.data_ptr() % 16:
        raise ValueError("scs_spmv: idx2, dat2 and lsl must start on 16-byte boundaries")
    if work is None:
        work = scs_work_list(segment_starts(bwin, nwin))
    if (work.nblocks, work.nwin) != (nblocks, nwin) or not 1 <= work.chunk_blocks <= 32:
        raise ValueError(f"scs_spmv: the work list was built for {work.nblocks} blocks, "
                         f"{work.nwin} windows and chunks of {work.chunk_blocks}, not for "
                         f"this plan's {nblocks} and {nwin} in chunks of at most 32")
    if nreal is None:
        nreal = scs_real_jsteps(idx2, jb)
    if nreal.shape != (nblocks,) or nreal.dtype is not torch.int32:
        raise ValueError("scs_spmv: nreal must be (B,) int32")
    x = x.to(torch.float32)
    check_cuda_operands("scs_spmv", btile, lsl, idx2, dat2, perm, x, nreal, *work[:4])
    return _launch(btile, lsl, idx2, dat2, perm, x, nreal, work, nrows, col_tile, C, sw, jb)


def _launch(btile, lsl, idx2, dat2, perm, x, nreal, work, nrows, col_tile, C, sw, jb):
    """The kernel's launch on operands :func:`scs_spmv` has checked."""
    from ._build import library

    no_grad_operands("scs_spmv", dat2, x)

    y = torch.empty(nrows, dtype=dat2.dtype, device=dat2.device)
    nchunks, nsplit = work.chunk_win.shape[0], work.split_win.shape[0]
    # partials only for windows of several chunks; none, no buffer
    partial = (torch.empty(nchunks * sw * C, dtype=torch.float32, device=dat2.device)
               if nsplit else None)
    library().call("repro_scs_spmv_chunked", *(t.data_ptr() for t in work[:4]),
                   btile.data_ptr(), nreal.data_ptr(), lsl.data_ptr(), idx2.data_ptr(),
                   dat2.data_ptr(), perm.data_ptr(), x.data_ptr(), y.data_ptr(),
                   None if partial is None else partial.data_ptr(), nchunks, nsplit, C, sw,
                   jb, col_tile, nrows, perm.shape[0], value_code("scs_spmv", dat2.dtype),
                   index_code("scs_spmv", idx2.dtype), current_stream(dat2.device))
    scs_spmv.launches += 1
    return y


scs_spmv.launches = 0


def scs_spmv_from_plan(plan, x, nrows: int) -> torch.Tensor:
    """Dispatch-table adapter: run :func:`scs_spmv` from a ``"scs"`` plan,
    with the real j-steps and the work list cached on the plan. The first
    call on the card checks the plan and the cached index in full; later
    calls check only ``x``."""
    btile, bwin, lsl, idx2, dat2, perm = plan.arrays
    ct, ntiles, C, sw, jb, nwin = (int(v) for v in plan.meta)
    cache = plan.cache
    if dat2.device.type == "cpu" or "work" not in cache:
        kw = {}
        if dat2.device.type != "cpu":
            kw = dict(nreal=scs_real_jsteps(idx2, jb),
                      work=scs_work_list(segment_starts(bwin, nwin)))
        y = scs_spmv(btile, bwin, lsl, idx2, dat2, perm, x, nrows=nrows, col_tile=ct,
                     ntiles=ntiles, C=C, sw=sw, jb=jb, nwin=nwin, **kw)
        cache.update(kw)  # only once scs_spmv has accepted them
        return y
    x = x.to(torch.float32)
    check_cuda_operands("scs_spmv", dat2, x)
    return _launch(btile, lsl, idx2, dat2, perm, x, cache["nreal"], cache["work"], nrows, ct,
                   C, sw, jb)
