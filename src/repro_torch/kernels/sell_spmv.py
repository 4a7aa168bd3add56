"""SELL-C-σ SpMV kernel (CUDA) over the ``"scs"`` plan, and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/sell_spmv.py:64``
(``scs_spmv``), which serves both ``csr`` and ``sell`` through the SELL-C-σ
view each container carries from convert time. The CUDA source is
``src/repro_torch/csrc/sell_spmv.cu``; its header note gives the design and
the byte bound. One warp owns one output window and walks that window's
run of blocks in order, so the result needs no float atomics and is the
same on every run.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device (or raises). Values accumulate in f32
over f32/bf16/f16 storage; int8/int16 tile-local indices are widened in the
kernel, so they give the bit-identical result of int32. y comes back in the
storage dtype.

``scs_spmv.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import torch

from ._launch import check_cuda_operands, current_stream, index_code, value_code

#: Slices per window the kernel holds in registers (csrc/sell_spmv.cu).
MAX_SLICE_WINDOW = 8


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


def window_runs(bwin: torch.Tensor, nwin: int) -> torch.Tensor:
    """``run_start (nwin+1,)`` int32: window ``w`` owns blocks
    ``[run_start[w], run_start[w+1])`` of the window-major stream."""
    bounds = torch.arange(nwin + 1, dtype=bwin.dtype, device=bwin.device)
    return torch.searchsorted(bwin, bounds).to(torch.int32)


def scs_spmv(btile, bwin, lsl, idx2, dat2, perm, x, *, nrows: int,
             col_tile: int, ntiles: int, C: int, sw: int, jb: int, nwin: int,
             run_start=None) -> torch.Tensor:
    """y = A @ x over a ``build_scs_plan`` SELL-C-σ stream.

    Args:
        btile/bwin: (B,) int32 per-block column tile / output window.
        lsl: (B*jb,) int32 window-local slice of each j-step.
        idx2/dat2: (B*jb, C) tile-local columns (-1 pad) / values.
        perm: (nrows_pad,) σ-sorted row permutation (pad rows = nrows).
        x: (ncols,) dense vector.
        run_start: the cached :func:`window_runs` of ``bwin`` (computed
            here when omitted).

    Returns (nrows,) in original row order, in ``dat2``'s dtype.
    """
    if dat2.device.type == "cpu":
        return scs_spmv_plain(btile, bwin, lsl, idx2, dat2, perm, x, nrows=nrows,
                              col_tile=col_tile, ntiles=ntiles, C=C, sw=sw,
                              jb=jb, nwin=nwin)
    if C <= 0 or C > 32 or 32 % C or not 0 < sw <= MAX_SLICE_WINDOW:
        raise ValueError(f"scs_spmv: the kernel takes C dividing 32 and at most "
                         f"{MAX_SLICE_WINDOW} slices per window, got C={C} sw={sw}")
    nblocks = btile.shape[0]
    if idx2.shape != (nblocks * jb, C) or dat2.shape != idx2.shape \
            or lsl.shape != (nblocks * jb,):
        raise ValueError("scs_spmv: plan arrays disagree with (B, jb, C)")
    for name, t in (("btile", btile), ("bwin", bwin), ("lsl", lsl), ("perm", perm)):
        if t.dtype is not torch.int32:
            raise TypeError(f"scs_spmv: {name} must be int32, got {t.dtype}")
    if run_start is None:
        run_start = window_runs(bwin, nwin)
    x = x.to(torch.float32)
    check_cuda_operands("scs_spmv", btile, lsl, idx2, dat2, perm, run_start, x)
    vcode = value_code("scs_spmv", dat2.dtype)
    icode = index_code("scs_spmv", idx2.dtype)
    y = torch.empty(nrows, dtype=dat2.dtype, device=dat2.device)
    from ._build import library

    library().call("repro_scs_spmv", btile.data_ptr(), lsl.data_ptr(),
                   idx2.data_ptr(), dat2.data_ptr(), perm.data_ptr(),
                   run_start.data_ptr(), x.data_ptr(), y.data_ptr(), nwin, C, sw,
                   jb, col_tile, nrows, perm.shape[0], vcode, icode,
                   current_stream(dat2.device))
    scs_spmv.launches += 1
    return y


scs_spmv.launches = 0


def scs_spmv_from_plan(plan, x, nrows: int) -> torch.Tensor:
    """Dispatch-table adapter: run :func:`scs_spmv` from a ``"scs"`` plan,
    with the window runs cached on the plan."""
    btile, bwin, lsl, idx2, dat2, perm = plan.arrays
    ct, ntiles, C, sw, jb, nwin = (int(v) for v in plan.meta)
    run_start = None
    if dat2.device.type != "cpu":
        run_start = plan.cache.get("run_start")
        if run_start is None:
            run_start = plan.cache["run_start"] = window_runs(bwin, nwin)
    return scs_spmv(btile, bwin, lsl, idx2, dat2, perm, x, nrows=nrows,
                    col_tile=ct, ntiles=ntiles, C=C, sw=sw, jb=jb, nwin=nwin,
                    run_start=run_start)
