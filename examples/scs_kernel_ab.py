"""Versions of the SELL-C-σ kernel (csr/cuda, sell/cuda) side by side, in one
process, on the card.

  python examples/scs_kernel_ab.py [--chunk-blocks K[,K...]] OLD.cu NEW.cu [MORE.cu ...]

Each argument is a version of ``src/repro_torch/csrc/sell_spmv.cu``. Each is
built on its own with the port's nvcc flags into ``build/scs_kernel_ab/``
and loaded with ctypes. A version with ``repro_scs_spmv_chunked`` runs over
the plan's real j-steps and a work list cut at each chunk size K given
(default the port's ``CHUNK_BLOCKS``), one timed version per K; an older
one runs ``repro_scs_spmv``, one warp per window. Cases (the csr
container's ``"scs"`` plan, f32 values):

  - ``hpcg104``: HPCG 104^3 (``fdm27``), the tiled plan (int16 ids);
  - ``powerlaw``: ``powerlaw(10**6, 8)``, resident, one row of 543,351
    entries;
  - ``block``: ``block_random(65536, 32, 16/2048)``, resident, rows of
    about 542 entries;
  - ``hpcg52``: HPCG 52^3, resident.

Each case prints the bytes the function needs (each entry's id and value,
x, y, perm and the cached index) and the bytes of the real j-steps the
kernel stages, each with its time at 3.35 TB/s. Each result is held against
the plain version (rtol 2e-4) and over two launches; then the versions are
timed in alternating rounds
(``examples/_kernel_ab.py``). Compare versions only within one run. Needs a
CUDA card and nvcc.
"""
import ctypes
import sys

import numpy as np
import torch

from _kernel_ab import build, time_versions  # also puts src/ on the path

from repro_torch.core import matrices as M
from repro_torch.core.convert import to_csr
from repro_torch.kernels import _build
from repro_torch.kernels._launch import segment_starts
from repro_torch.kernels.sell_spmv import (CHUNK_BLOCKS, scs_real_jsteps, scs_spmv_plain,
                                           scs_work_list)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {
    # one warp per window (the port's kernel up to this redesign)
    "repro_scs_spmv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _I, _I,
                       _P),
    "repro_scs_spmv_chunked": _build._SIGNATURES["repro_scs_spmv_chunked"],
}


def matrices():
    return {"hpcg104": M.fdm27(104, 104, 104), "powerlaw": M.powerlaw(10 ** 6, 8),
            "block": M.block_random(65536, 32, block_density=16 / 2048, seed=0),
            "hpcg52": M.fdm27(52, 52, 52)}


def case(name, s, libs, chunk_sizes, dev):
    """Every version's launch on ``s``'s plan, keyed by its label, and the
    plain result."""
    n = s.shape[0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(s.shape[1])
                         .astype(np.float32)).to(dev)
    A = to_csr(s, device=dev)
    btile, bwin, lsl, idx2, dat2, perm = A.plan.arrays
    ct, ntiles, C, sw, jb, nwin = A.plan.meta
    runs = segment_starts(bwin, nwin)
    nreal = scs_real_jsteps(idx2, jb)
    icode = _build.INDEX_CODES[str(idx2.dtype).replace("torch.", "")]
    real = int(nreal.sum())
    # the cached index at the port's chunk size: nreal and the work list
    index = sum(t.numel() * 4 for t in (nreal, *scs_work_list(runs)[:4]))
    needed = (s.nnz * (idx2.element_size() + dat2.element_size())
              + 4 * (x.numel() + n + perm.numel()) + index)
    staged = (real * (C * (idx2.element_size() + dat2.element_size()) + 4)
              + 4 * (x.numel() + n + perm.numel() + btile.numel()) + index)
    print(f"{name}: {n} rows, {s.nnz} entries, {ntiles} tiles, {btile.shape[0]} blocks, "
          f"{nwin} windows, longest run {int((runs[1:] - runs[:-1]).max())} blocks, "
          f"{real} real j-steps of {idx2.shape[0]}, index {idx2.dtype}, "
          f"needed_bytes={needed} bound_ms={needed / 3.35e9} "
          f"staged_bytes={staged} bound_staged_ms={staged / 3.35e9}", flush=True)
    launches = {}
    for src, lib in libs.items():
        if not hasattr(lib, "repro_scs_spmv_chunked"):
            def launch(out, lib=lib):
                return lib.repro_scs_spmv(
                    btile.data_ptr(), lsl.data_ptr(), idx2.data_ptr(), dat2.data_ptr(),
                    perm.data_ptr(), runs.data_ptr(), x.data_ptr(), out.data_ptr(), nwin, C,
                    sw, jb, ct, n, perm.shape[0], 0, icode, None)
            launches[src] = launch
            continue
        for k in chunk_sizes:
            work = scs_work_list(runs, k)
            nch, nsplit = work.chunk_win.shape[0], work.split_win.shape[0]
            part = torch.empty(nch * sw * C if nsplit else 0, device=dev)
            print(f"  {label(src, k)}: {nch} chunks, {nsplit} split windows", flush=True)

            def launch(out, lib=lib, work=work, part=part, nch=nch, nsplit=nsplit):
                return lib.repro_scs_spmv_chunked(
                    *(t.data_ptr() for t in work[:4]), btile.data_ptr(), nreal.data_ptr(),
                    lsl.data_ptr(), idx2.data_ptr(), dat2.data_ptr(), perm.data_ptr(),
                    x.data_ptr(), out.data_ptr(), part.data_ptr(), nch, nsplit, C, sw, jb,
                    ct, n, perm.shape[0], 0, icode, None)
            launches[label(src, k)] = launch
    want = scs_spmv_plain(*A.plan.arrays, x, nrows=n, col_tile=ct, ntiles=ntiles, C=C,
                          sw=sw, jb=jb, nwin=nwin)
    return launches, want, n, A


def label(src, k):
    return f"{src}[K={k}]"


def main(args):
    chunk_sizes = [CHUNK_BLOCKS]
    if args[0] == "--chunk-blocks":
        chunk_sizes, args = [int(k) for k in args[1].split(",")], args[2:]
    libs = build(args, "scs_kernel_ab", ENTRIES)
    versions = [label(src, k) if hasattr(lib, "repro_scs_spmv_chunked") else src
                for src, lib in libs.items()
                for k in (chunk_sizes if hasattr(lib, "repro_scs_spmv_chunked") else [0])]
    dev = torch.device("cuda")
    calls, keep = {}, []
    for name, s in matrices().items():
        launches, want, n, A = case(name, s, libs, chunk_sizes, dev)
        keep.append(A)
        atol = 2e-4 * float(want.abs().max())
        for version, fn in launches.items():
            y, y2 = torch.empty(n, device=dev), torch.empty(n, device=dev)
            if fn(y) or fn(y2):
                raise SystemExit(f"{name} {version}: launch failed")
            torch.cuda.synchronize()
            err = (y - want).abs()
            ok = bool((err <= atol + 2e-4 * want.abs()).all())
            print(f"check {name} {version}: within_rtol_2e-4={ok} "
                  f"max_abs_err={float(err.max())} repeat_equal={bool(torch.equal(y, y2))}",
                  flush=True)
            if not ok:
                raise SystemExit(f"{name} {version}: disagrees with the plain version")
            calls[(name, version)] = lambda fn=fn, y=y: fn(y)
    time_versions(versions, calls)


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    main(sys.argv[1:])
