"""Versions of the DIA kernels side by side, in one process, on the card.

  python examples/dia_kernel_ab.py OLD.cu NEW.cu [MORE.cu ...]

Each argument is a version of ``src/repro_torch/csrc/dia_spmv.cu``. Each is
built on its own with the port's nvcc flags into ``build/dia_kernel_ab/``
and loaded with ctypes. Cases (f32 values), on HPCG's four multigrid levels
(``fdm27`` at 104^3, 52^3, 26^3 and 13^3):

  - ``resident_<g>``: ``repro_dia_spmv`` on the whole level;
  - ``masked_<g>``: the same with the mask of the level's first SymGS color
    (``greedy_coloring``, as ``SymGS.build`` makes it: one row in eight on
    the 27-point stencil);
  - ``listed_<g>``: where the version has ``repro_dia_spmv_listed``, the
    same color through the list of its rows (built here once, on the card);
  - ``tiled_104`` and ``tiled_masked_104``: ``repro_dia_spmv_tiled`` on the
    104^3 level's ``"dia-cols"`` plan under ``max_resident_cols=1<<18``
    (the column-limited CG's plan: column tiles of 16,384), whole and on
    the first color.

Each result is held against the plain version bit for bit (a masked one
against ``where(mask, A @ x, 0)``) and over two launches, and each case
prints its bound: every stored value, x and y for a whole level (for the
tiled plan its windows and offsets, x and y); for a color, the in-range
values of its rows, the distinct x words they read, the mask and y
(written whole), at 3.35 TB/s. Then the versions are timed
in alternating rounds (``examples/_kernel_ab.py``). Compare versions only
within one run. Needs a CUDA card and nvcc.
"""
import sys

import numpy as np
import torch

from _kernel_ab import build, time_versions  # also puts src/ on the path

from repro_torch.core import ExecutionPolicy
from repro_torch.core import matrices as M
from repro_torch.core.convert import to_dia
from repro_torch.kernels.dia_spmv import dia_spmv_plain, dia_spmv_tiled_plain
from repro_torch.solvers.symgs import greedy_coloring

GRIDS = (104, 52, 26, 13)
#: The ``max_resident_cols`` that sends the 104^3 level to the tiled kernel.
COLUMN_LIMIT = 1 << 18
HBM_BYTES_PER_MS = 3.35e9


def color_bytes(offsets, mask, n):
    """Bytes a masked call needs: the in-range values of the mask's rows
    (f32), the distinct x words they read, the mask and y."""
    rows = mask.nonzero().flatten().long()
    seen = torch.zeros(n, dtype=torch.bool, device=mask.device)
    values = 0
    for off in offsets.tolist():
        k = rows + off
        k = k[(k >= 0) & (k < n)]
        values += k.numel()
        seen[k] = True
    return 4 * values + 4 * int(seen.sum()) + n + 4 * n


def main(sources):
    libs = build(sources, "dia_kernel_ab",
                 ("repro_dia_spmv", "repro_dia_spmv_listed", "repro_dia_spmv_tiled"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = {}
    for g in GRIDS:
        s = M.fdm27(g, g, g)
        n = s.shape[0]
        D = to_dia(s, device=dev)
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        mask = torch.from_numpy(greedy_coloring(s) == 0).to(dev)
        rows = mask.nonzero().flatten().to(torch.int32)
        want = dia_spmv_plain(D.offsets, D.data, x)
        zero = torch.zeros((), device=dev)
        whole = D.offsets.numel() * 4 + D.data.numel() * 4 + 8 * n
        part = color_bytes(D.offsets, mask, n)
        print(f"{g}^3: {n} rows, {D.ndiags} diagonals, color rows {rows.numel()}, "
              f"bound_ms={whole / HBM_BYTES_PER_MS} color_bound_ms={part / HBM_BYTES_PER_MS}",
              flush=True)

        def launch(lib, out, m=None, D=D, x=x, n=n):
            return lib.repro_dia_spmv(D.offsets.data_ptr(), D.data.data_ptr(), x.data_ptr(),
                                      None if m is None else m.data_ptr(), out.data_ptr(),
                                      D.ndiags, n, n, 0, None)

        def listed(lib, out, D=D, x=x, n=n, mask=mask, rows=rows):
            return lib.repro_dia_spmv_listed(
                D.offsets.data_ptr(), D.data.data_ptr(), x.data_ptr(), mask.data_ptr(),
                rows.data_ptr(), rows.numel(), out.data_ptr(), D.ndiags, n, n, 0, None)

        masked_want = torch.where(mask, want, zero)
        cases[f"resident_{g}"] = (launch, want, n, None)
        cases[f"masked_{g}"] = (lambda lib, out, f=launch, m=mask: f(lib, out, m),
                                masked_want, n, None)
        cases[f"listed_{g}"] = (listed, masked_want, n, "repro_dia_spmv_listed")
        if g != GRIDS[0]:
            continue
        DT = to_dia(s, col_tile=ExecutionPolicy(max_resident_cols=COLUMN_LIMIT).col_tile(n),
                    device=dev)
        offs_t, dat_w = DT.plan.arrays
        ntiles, max_d, ct = dat_w.shape
        lo, hi = int(offs_t.min()), int(offs_t.max())
        tiled_bytes = offs_t.numel() * 4 + dat_w.numel() * 4 + 8 * n
        print(f"{g}^3 tiled: ct={ct} ntiles={ntiles} max_d={max_d} offsets [{lo}, {hi}] "
              f"bound_ms={tiled_bytes / HBM_BYTES_PER_MS}", flush=True)

        def tiled(lib, out, m=None, offs_t=offs_t, dat_w=dat_w, x=x, n=n):
            return lib.repro_dia_spmv_tiled(
                offs_t.data_ptr(), dat_w.data_ptr(), x.data_ptr(),
                None if m is None else m.data_ptr(), out.data_ptr(), ntiles, max_d, ct, n, n,
                lo, hi, 0, None)

        tiled_want = dia_spmv_tiled_plain(offs_t, dat_w, x, n, ct)
        cases[f"tiled_{g}"] = (tiled, tiled_want, n, "repro_dia_spmv_tiled")
        cases[f"tiled_masked_{g}"] = (lambda lib, out, m=mask: tiled(lib, out, m),
                                      torch.where(mask, tiled_want, zero), n,
                                      "repro_dia_spmv_tiled")

    calls = {}
    for case, (fn, want, rows, needs) in cases.items():
        for src, lib in libs.items():
            if needs is not None and not hasattr(lib, needs):
                continue
            y, y2 = torch.empty(rows, device=dev), torch.empty(rows, device=dev)
            if fn(lib, y) or fn(lib, y2):
                raise SystemExit(f"{case} {src}: launch failed")
            torch.cuda.synchronize()
            print(f"check {case} {src}: equal_to_plain={bool(torch.equal(y, want))} "
                  f"max_abs_err={float((y - want).abs().max())} "
                  f"repeat_equal={bool(torch.equal(y, y2))}", flush=True)
            calls[(case, src)] = lambda fn=fn, lib=lib, y=y: fn(lib, y)
    time_versions(sources, calls)


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    main(sys.argv[1:])
