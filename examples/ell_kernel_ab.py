"""Versions of the ELL kernels side by side, in one process, on the card.

  python examples/ell_kernel_ab.py OLD.cu NEW.cu [MORE.cu ...]

Each argument is a version of ``src/repro_torch/csrc/ell_spmv.cu``. Each is
built on its own with the port's nvcc flags into ``build/ell_kernel_ab/``
and loaded with ctypes. Cases (f32 values):

  - ``tiled``: HPCG 104^3 (``fdm27``) over its ``"ell-cols"`` plan (int16
    ids), a chunk of 128 rows reaching 2 or 3 of the 69 column tiles;
  - ``scattered``: ``random_uniform(1_200_000, 8e-6)`` over its
    ``"ell-cols"`` plan, x past the column limit and about 9.6 entries
    per row spread over 74 tiles, so every chunk reaches every tile and
    the plan's slots are mostly padding;
  - ``resident`` and ``masked``: HPCG 52^3 (int32 ids, global), whole and
    with every eighth row kept, through ``repro_ell_spmv`` where the
    version has it, else ``repro_ell_spmv_listed`` over the arrays as a
    plan of one tile; and ``resident_13`` at 13^3.

Each tiled case also runs masked (``tiled_masked``, ``scattered_masked``,
every eighth row kept). A tiled case runs ``repro_ell_spmv_listed`` with
the plan's tile index where the version has it, else ``repro_ell_spmv``
over every tile. Each result is held against the plain version bit for bit (the masked one
against ``where(mask, A @ x, 0)``) and over two launches; then the versions
are timed in alternating rounds (``examples/_kernel_ab.py``). Compare
versions only within one run. Needs a CUDA card and nvcc.
"""
import ctypes
import sys

import numpy as np
import torch

from _kernel_ab import build, time_versions  # also puts src/ on the path

from repro_torch.core import matrices as M
from repro_torch.core.convert import to_ell
from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmv import (ell_spmv_plain, ell_spmv_tiled_plain,
                                          ell_tile_index)

GRID = 104
SCATTERED = (1_200_000, 8e-6)
#: The argument types of the resident entry of versions that have one.
RESIDENT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]


def tiled_cases(name, s, x):
    """``name`` and ``name_masked`` (every eighth row kept) over ``s``'s
    plan: a tiled version's launch, the plain result, the row count."""
    E = to_ell(s, device=x.device)
    idx_t, dat_t = E.plan.arrays
    n, ct, ntiles, width = s.shape[0], E.plan.ct, E.plan.ntiles, int(idx_t.shape[2])
    tile_ptr, tile_ids, _ = ell_tile_index(idx_t)
    icode = _build.INDEX_CODES[str(idx_t.dtype).replace("torch.", "")]
    mask = torch.from_numpy((np.arange(n) % 8) == 3).to(x.device)
    want = ell_spmv_tiled_plain(idx_t, dat_t, x, col_tile=ct)
    # bound: the real ids and values, x, y and the index, once, at 3.35 TB/s
    needed = (int((idx_t >= 0).sum()) * (idx_t.element_size() + dat_t.element_size())
              + 4 * (x.numel() + n + tile_ptr.numel() + tile_ids.numel()))
    print(f"{name}: {n} rows, {s.nnz} entries, {ntiles} tiles, width {width}, "
          f"{idx_t.numel()} slots, {int(tile_ids.shape[0])} listed (chunk, tile) pairs of "
          f"{int(tile_ptr.shape[0]) - 1} chunks, needed_bytes={needed} "
          f"bound_ms={needed / 3.35e9}", flush=True)
    cases = {}
    for case, m in ((name, None), (f"{name}_masked", mask)):
        def launch(lib, out, m=m):
            mp = None if m is None else m.data_ptr()
            if hasattr(lib, "repro_ell_spmv_listed"):
                return lib.repro_ell_spmv_listed(
                    idx_t.data_ptr(), dat_t.data_ptr(), x.data_ptr(), mp, tile_ptr.data_ptr(),
                    tile_ids.data_ptr(), out.data_ptr(), n, width, ct, 0, icode, None)
            return lib.repro_ell_spmv(idx_t.data_ptr(), dat_t.data_ptr(), x.data_ptr(), mp,
                                      out.data_ptr(), n, width, ntiles, ct, 0, icode, None)

        cases[case] = (launch, want if m is None else
                       torch.where(m, want, torch.zeros((), device=x.device)), n)
    return cases


def main(sources):
    libs = build(sources, "ell_kernel_ab", {
        "repro_ell_spmv": RESIDENT_ARGS,
        "repro_ell_spmv_listed": _build._SIGNATURES["repro_ell_spmv_listed"]})
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)

    cases = {**tiled_cases("tiled", M.fdm27(GRID, GRID, GRID), vec(GRID ** 3)),
             **tiled_cases("scattered", M.random_uniform(*SCATTERED), vec(SCATTERED[0]))}

    for g, names in ((GRID // 2, ("resident", "masked")), (GRID // 8, ("resident_13",))):
        sg = M.fdm27(g, g, g)
        ng = sg.shape[0]
        xg = vec(ng)
        R = to_ell(sg, device=dev)
        tile_ptr, tile_ids, _ = ell_tile_index(R.indices.unsqueeze(0))
        mask = torch.from_numpy((np.arange(ng) % 8) == 3).to(dev)
        want = ell_spmv_plain(R.indices, R.data, xg)
        # bound: every id slot, the real values, x and y, once, at 3.35 TB/s
        needed = 4 * (R.indices.numel() + int((R.indices >= 0).sum()) + 2 * ng)
        print(f"resident {g}^3: {ng} rows, width {R.width}, needed_bytes={needed} "
              f"bound_ms={needed / 3.35e9}", flush=True)
        for name, m in zip(names, (None, mask)):
            def resident(lib, out, m=m, R=R, xg=xg, ng=ng, tp=tile_ptr, ti=tile_ids):
                mp = None if m is None else m.data_ptr()
                if hasattr(lib, "repro_ell_spmv"):
                    return lib.repro_ell_spmv(R.indices.data_ptr(), R.data.data_ptr(),
                                              xg.data_ptr(), mp, out.data_ptr(), ng, R.width,
                                              1, 0, 0, _build.INDEX_CODES["int32"], None)
                return lib.repro_ell_spmv_listed(
                    R.indices.data_ptr(), R.data.data_ptr(), xg.data_ptr(), mp, tp.data_ptr(),
                    ti.data_ptr(), out.data_ptr(), ng, R.width, ng, 0,
                    _build.INDEX_CODES["int32"], None)

            cases[name] = (resident, want if m is None else
                           torch.where(m, want, torch.zeros((), device=dev)), ng)

    calls = {}
    for case, (fn, want, rows) in cases.items():
        y = torch.empty(rows, device=dev)
        for src, lib in libs.items():
            y2 = torch.empty(rows, device=dev)
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
