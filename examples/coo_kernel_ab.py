"""Versions of the full-window COO kernel side by side, in one process, on the card.

  python examples/coo_kernel_ab.py OLD.cu NEW.cu [MORE.cu ...]

Each argument is a version of ``src/repro_torch/csrc/coo_spmv.cu``. Each is
built on its own with the port's nvcc flags into ``build/coo_kernel_ab/``
and loaded with ctypes. Every version runs ``repro_coo_spmv`` on the
row-sorted COO of HPCG's 13^3 level (the size at which the HPCG path takes
the full window), and of the 27-point stencil at 26^3, 35^3 and 52^3 (past
``max_onehot_rows``, as a policy that raises that limit would send them
there: 17,576, 42,875 and 140,608 rows, on both sides of the row counts at
which a row-per-thread CTA grows to 128 and 256 threads), f32 values, with
the segment starts found once. Each result is held against the plain version
bit for bit and over two launches, and each case prints its bound: the
segment starts, each entry's column and value, x and y, at 3.35 TB/s. Then
the versions are timed in alternating rounds (``examples/_kernel_ab.py``).
Compare versions only within one run. Needs a CUDA card and nvcc.
"""
import sys

import numpy as np
import torch

from _kernel_ab import build, time_versions  # also puts src/ on the path

from repro_torch.core import matrices as M
from repro_torch.core.convert import to_coo
from repro_torch.kernels._launch import segment_starts
from repro_torch.kernels.coo_spmv import coo_spmv_plain

GRIDS = (13, 26, 35, 52)
HBM_BYTES_PER_MS = 3.35e9


def main(sources):
    libs = build(sources, "coo_kernel_ab", ("repro_coo_spmv",))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    calls = {}
    for g in GRIDS:
        s = M.fdm27(g, g, g)
        n = s.shape[0]
        C = to_coo(s, device=dev)
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        starts = segment_starts(C.row, n)
        moved = 4 * starts.numel() + 8 * C.nnz + 8 * n
        print(f"{g}^3: {n} rows, {C.nnz} entries, bound_ms={moved / HBM_BYTES_PER_MS}",
              flush=True)
        want = coo_spmv_plain(C.row, C.col, C.val, x, n)

        def launch(lib, out, C=C, x=x, n=n, starts=starts):
            return lib.repro_coo_spmv(starts.data_ptr(), C.col.data_ptr(), C.val.data_ptr(),
                                      x.data_ptr(), out.data_ptr(), n, n, 0, None)

        for src, lib in libs.items():
            y, y2 = torch.empty(n, device=dev), torch.empty(n, device=dev)
            if launch(lib, y) or launch(lib, y2):
                raise SystemExit(f"coo_{g} {src}: launch failed")
            torch.cuda.synchronize()
            print(f"check coo_{g} {src}: equal_to_plain={bool(torch.equal(y, want))} "
                  f"max_abs_err={float((y - want).abs().max())} "
                  f"repeat_equal={bool(torch.equal(y, y2))}", flush=True)
            calls[(f"coo_{g}", src)] = lambda lib=lib, y=y, f=launch: f(lib, y)
    time_versions(sources, calls)


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    main(sys.argv[1:])
