"""Versions of the sliced COO kernel side by side, in one process, on the card.

  python examples/scoo_kernel_ab.py OLD.cu NEW.cu [MORE.cu ...]

Each argument is a version of ``src/repro_torch/csrc/coo_spmv.cu``. Each is
built on its own with the port's nvcc flags into ``build/scoo_kernel_ab/``
and loaded with ctypes. On HPCG 104^3 (``fdm27``, f32 values) every version
runs ``repro_scoo_spmv_tiled`` over the ``"coo-cols"`` plan and, where it
has ``repro_scoo_spmv``, over the ``build_scoo`` layout (slices and blocks
of 512) of a row-sorted COO (``csr``) and of a column-major one (``csc``).
Each result is held against the plain version (max abs error, equal bits
over two launches); then the versions are timed in alternating rounds
(``examples/_kernel_ab.py``). Compare versions only within one run. Needs
a CUDA card and nvcc.
"""
import sys

import numpy as np
import torch

from _kernel_ab import build, time_versions  # also puts src/ on the path

from repro_torch.core import matrices as M
from repro_torch.core.convert import to_coo
from repro_torch.kernels import _build
from repro_torch.kernels._launch import segment_starts
from repro_torch.kernels.coo_spmv import build_scoo, scoo_spmv_plain, scoo_spmv_tiled_plain

GRID = 104
SLICE = 512


def main(sources):
    libs = build(sources, "scoo_kernel_ab", ("repro_scoo_spmv_tiled", "repro_scoo_spmv"))
    dev = torch.device("cuda")
    s = M.fdm27(GRID, GRID, GRID)
    n = s.shape[0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32)).to(dev)
    y = torch.empty(n, device=dev)

    C = to_coo(s, device=dev)
    row, col, val, sid, ctile = C.plan.arrays
    ct, _, slice_rows, tile = C.plan.meta
    runs = segment_starts(sid, -(-n // slice_rows))
    icode = _build.INDEX_CODES[str(col.dtype).replace("torch.", "")]

    def tiled(lib, out):
        return lib.repro_scoo_spmv_tiled(
            row.data_ptr(), col.data_ptr(), val.data_ptr(), ctile.data_ptr(), runs.data_ptr(),
            x.data_ptr(), out.data_ptr(), runs.shape[0] - 1, tile, slice_rows, ct, n, n, 0,
            icode, None)

    cases = {"tiled": ("repro_scoo_spmv_tiled", tiled, scoo_spmv_tiled_plain(
        row, col, val, sid, ctile, x, nrows=n, col_tile=ct, tile=tile))}
    for order in ("csr", "csc"):
        coo = s.tocoo() if order == "csr" else s.tocsc().tocoo()
        r, c, v, sd = (torch.from_numpy(a).to(dev) for a in build_scoo(
            coo.row, coo.col, coo.data.astype(np.float32), n, SLICE, SLICE))
        rs = segment_starts(sd, -(-n // SLICE))

        def scoo(lib, out, r=r, c=c, v=v, rs=rs):
            return lib.repro_scoo_spmv(r.data_ptr(), c.data_ptr(), v.data_ptr(), rs.data_ptr(),
                                       x.data_ptr(), out.data_ptr(), rs.shape[0] - 1, SLICE,
                                       SLICE, n, n, 0, None)

        cases[f"scoo_{order}"] = ("repro_scoo_spmv", scoo,
                                  scoo_spmv_plain(r, c, v, sd, x, nrows=n))

    calls = {}
    for case, (entry, fn, want) in cases.items():
        for src, lib in libs.items():
            if not hasattr(lib, entry):
                continue
            y2 = torch.empty_like(y)
            if fn(lib, y) or fn(lib, y2):
                raise SystemExit(f"{case} {src}: launch failed")
            print(f"check {case} {src}: max_abs_err={float((y - want).abs().max())} "
                  f"repeat_equal={bool(torch.equal(y, y2))}", flush=True)
            calls[(case, src)] = lambda fn=fn, lib=lib: fn(lib, y)
    time_versions(sources, calls)


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    main(sys.argv[1:])
