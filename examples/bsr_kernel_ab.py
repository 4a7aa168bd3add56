"""Versions of the BSR SpMM kernel side by side, in one process, on the card.

  python examples/bsr_kernel_ab.py OLD.cu NEW.cu [MORE.cu ...]

Each argument is a version of ``src/repro_torch/csrc/bsr_spmm.cu``. Each is
built on its own with the port's nvcc flags into ``build/bsr_kernel_ab/``
and loaded with ctypes; every version runs ``repro_bsr_spmm``. Cases, on
the block path's matrix ``block_random(65536, 32, 16/2048)`` (34,699
blocks of 32x32, f32): ``nf1`` (SpMV) and ``nf128`` (SpMM of 128 columns),
each also masked (``masked_nf1``, ``masked_nf128``: every eighth row
kept). Each result is held against the plain version (rtol 2e-4) and over
two launches, a masked one against ``where(mask, Y, 0)`` of the same
version bit for bit. Each version, and the plain version, also prints its
error against an f64 oracle (the stored f32 values and X in f64, a
cuSPARSE product on the card): the max abs error and the largest ratio of
the error to the conformance grid's f32 tolerance, ``2e-4 + 2e-4 * |y|``
(at most 1 meets it); and whether a 0/1 matrix with at most one 1 a row
(MoE dispatch's kind) gives X's rows back bit for bit at 128 columns.
Then the versions are timed in alternating rounds
(``examples/_kernel_ab.py``), with torch's own BSR product
(``torch.sparse_bsr_tensor @ X``) on the same operands as a yardstick.
Compare versions only within one run. Needs a CUDA card and nvcc.
"""
import sys

import numpy as np
import scipy.sparse as sp
import torch

from _kernel_ab import build, time_versions  # also puts src/ on the path

from repro_torch.core import matrices as M
from repro_torch.core.convert import to_bsr
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm import bsr_spmm_path, bsr_spmm_plain

LIBRARY = "torch.sparse_bsr_tensor"


def main(sources):
    libs = build(sources, "bsr_kernel_ab", ("repro_bsr_spmm",))
    dev = torch.device("cuda")
    s = M.block_random(65536, 32, block_density=16 / 2048, seed=0)
    n = s.shape[0]
    B = to_bsr(s, device=dev)
    valid = B.bcols >= 0
    lib_A = torch.sparse_bsr_tensor(
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), valid.sum(1).cumsum(0)]),
        B.bcols[valid].long(), B.blocks[valid], size=s.shape)
    mask = torch.from_numpy((np.arange(n) % 8) == 3).to(dev)
    print(f"block: {n} rows, {int(valid.sum())} blocks of {B.bs}, bwidth {B.bwidth}",
          flush=True)
    c = s.tocsr()
    A64 = torch.sparse_csr_tensor(torch.from_numpy(c.indptr.astype(np.int64)),
                                  torch.from_numpy(c.indices.astype(np.int64)),
                                  torch.from_numpy(c.data.astype(np.float32).astype(np.float64)),
                                  size=s.shape).to(dev)

    def f64_error(Y, want64):
        err = (Y.double() - want64).abs()
        return (f"f64_max_abs_err={float(err.max())} "
                f"f64_tol_ratio={float((err / (2e-4 + 2e-4 * want64.abs())).max())}")

    # a one-hot dispatch: row i takes X row perm[i] of block row i's block
    # column, or nothing
    rng = np.random.default_rng(5)
    perm = rng.permutation(n)
    keep = rng.random(n) < 0.9
    onehot = to_bsr(sp.csr_matrix((np.ones(int(keep.sum()), np.float32),
                                   (np.nonzero(keep)[0], perm[keep])), shape=(n, n)),
                    device=dev)
    calls = {}
    for nf in (1, 128):
        X = torch.from_numpy(np.random.default_rng(3).standard_normal((n, nf))
                             .astype(np.float32)).to(dev)
        want = bsr_spmm_plain(B.bcols, B.blocks, X)
        want64 = A64 @ X.double()
        print(f"check nf{nf} plain: {f64_error(want, want64)}", flush=True)
        gathered = torch.where(torch.from_numpy(keep).to(dev)[:, None],
                               X[torch.from_numpy(perm).to(dev)], torch.zeros((), device=dev))
        atol = 2e-4 * float(want.abs().max())
        print(f"nf{nf}: the new kernel's path is {bsr_spmm_path(B.bs, nf)}", flush=True)
        for src, lib in libs.items():
            def launch(out, m=None, lib=lib, X=X, nf=nf):
                return lib.repro_bsr_spmm(
                    B.bcols.data_ptr(), B.blocks.data_ptr(), X.data_ptr(),
                    None if m is None else m.data_ptr(), out.data_ptr(), B.bcols.shape[0],
                    B.bwidth, B.bs, n, nf, _build.VALUE_CODES["float32"], None)

            Y, Y2, Ym = (torch.empty((n, nf), device=dev) for _ in range(3))
            if launch(Y) or launch(Y2) or launch(Ym, mask):
                raise SystemExit(f"nf{nf} {src}: launch failed")
            torch.cuda.synchronize()
            err = (Y - want).abs()
            ok = bool((err <= atol + 2e-4 * want.abs()).all())
            masked = bool(torch.equal(Ym, torch.where(mask[:, None], Y,
                                                      torch.zeros((), device=dev))))
            Yo = torch.empty((onehot.bcols.shape[0] * onehot.bs, nf), device=dev)
            if lib.repro_bsr_spmm(onehot.bcols.data_ptr(), onehot.blocks.data_ptr(),
                                  X.data_ptr(), None, Yo.data_ptr(), onehot.bcols.shape[0],
                                  onehot.bwidth, onehot.bs, n, nf,
                                  _build.VALUE_CODES["float32"], None):
                raise SystemExit(f"nf{nf} {src}: one-hot launch failed")
            torch.cuda.synchronize()
            print(f"check nf{nf} {src}: within_rtol_2e-4={ok} max_abs_err={float(err.max())} "
                  f"repeat_equal={bool(torch.equal(Y, Y2))} masked_exact={masked} "
                  f"{f64_error(Y, want64)} "
                  f"one_hot_exact={bool(torch.equal(Yo[:n], gathered))}", flush=True)
            if not (ok and masked):
                raise SystemExit(f"nf{nf} {src}: disagrees with the plain version")
            calls[(f"nf{nf}", src)] = lambda launch=launch, Y=Y: launch(Y)
            calls[(f"masked_nf{nf}", src)] = lambda launch=launch, Y=Ym: launch(Y, mask)
        calls[(f"nf{nf}", LIBRARY)] = lambda X=X: lib_A @ X
    for (case, src), fn in calls.items():  # a fault shows at the call that made it
        print(f"run {case} {src}", flush=True)
        fn()
        torch.cuda.synchronize()
    time_versions(sources + [LIBRARY], calls)


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    main(sys.argv[1:])
