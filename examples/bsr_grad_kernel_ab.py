"""Versions of the backward BSR kernels side by side, in one process, on the card.

  python examples/bsr_grad_kernel_ab.py OLD.cu NEW.cu [MORE.cu ...]

Each argument is a version of ``src/repro_torch/csrc/bsr_spmm_grad.cu``, for
example the first design, saved with ``git show
42a065e:src/repro_torch/csrc/bsr_spmm_grad.cu > build/ab_src/old_grad.cu``
(``build/`` is copied to the card; a version that includes a header of
``csrc/`` finds it there). Each is built on its own with the port's nvcc
flags into ``build/bsr_grad_kernel_ab/`` and loaded with ctypes; every
version runs ``repro_bsr_spmm_t`` (dX = A^T dY) and ``repro_bsr_sddmm`` (dB
= dY X^T at the stored blocks) on one column-sorted work list; each
version's entries get the operands their own parameter lists name (the
first design's ``repro_bsr_sddmm`` takes ``bcols``; a version with the
queries ``repro_bsr_spmm_t_scratch`` / ``repro_bsr_sddmm_scratch`` gets a
``scratch`` buffer of the size each gives).

Cases: the seven of ``chip_smoke.py`` phase 15a, made by its
``train_kernel_cases`` from its seeds: dX at qwen3-moe-235b-a22b's training
dispatch (10,240 x 1,024, bs 8, bf16 blocks, 4,096 columns), dH and dB at
its combine (1,024 x 10,241) routed by a random router and as the training
step's first batch routes it (the model built at full width with one
layer), dX and dB on the block matrix
``block_random(65536, 32, 16/2048)`` at 128 columns. Each result is held
against its plain version (rtol 2e-4, atol 2e-4 max|want|) and over two
launches (equal bits); then the versions are timed in alternating rounds
(``examples/_kernel_ab.py``) beside torch's BSR product on A^T and
``torch.sparse.sampled_addmm`` over the blocks' entries, the yardsticks of
phase 15a. Compare versions only within one run. Needs a CUDA card and nvcc.
"""
import ctypes
import os
import re
import sys

import torch

from _kernel_ab import build, time_versions  # also puts src/ on the path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as smoke  # noqa: E402
from repro_torch.core import matrices as M  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bsr_spmm import (bsr_column_order, bsr_sddmm_plain,  # noqa: E402
                                          bsr_spmm_t_plain)

TRANSPOSE = "torch.sparse_bsr_tensor(A^T)"
SAMPLED = "torch.sparse.sampled_addmm"


#: ctypes types of the C entries' parameters, by name (pointers elsewhere).
ARG_TYPES = {"bwidth": ctypes.c_int, "bs": ctypes.c_int, "dtype": ctypes.c_int,
             "nslots": ctypes.c_longlong, "nbcols": ctypes.c_longlong,
             "ncols": ctypes.c_longlong, "nf": ctypes.c_longlong}


def entry(src: str, lib, name: str):
    """``lib``'s C entry ``name`` as ``src`` declares it: a call taking the
    operands by parameter name."""
    with open(src) as f:
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", f.read())
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    fn = getattr(lib, name)
    fn.argtypes = [ARG_TYPES.get(p, ctypes.c_void_p) for p in params]
    return lambda **vals: fn(*(vals[p] for p in params))


def scratch(lib, query: str, *args, device):
    """A buffer of the bytes ``lib``'s ``query`` asks for, or ``None`` when
    the version has no such query."""
    fn = getattr(lib, query, None)
    if fn is None:
        return None
    fn.argtypes = list(_build._SIGNATURES[query])
    fn.restype = ctypes.c_longlong
    return torch.empty((fn(*args),), dtype=torch.uint8, device=device)


def main(sources):
    libs = build(sources, "bsr_grad_kernel_ab", ("repro_bsr_spmm_t", "repro_bsr_sddmm"))
    block = M.block_random(*smoke.BLOCK_MATRIX[:2], block_density=smoke.BLOCK_MATRIX[2],
                           seed=0)
    calls, keep = {}, []
    for label, P, X, dY, ncols, dx_only in smoke.train_kernel_cases(block):
        bcols, blocks, bs = P.bcols, P.blocks, P.bs
        bwidth = bcols.shape[1]
        nbcols, nf = -(-ncols // bs), dY.shape[1]
        work = bsr_column_order(bcols, nbcols)
        order, starts = work
        keep.append((P, X, dY, work))
        common = {"order": order.data_ptr(), "starts": starts.data_ptr(),
                  "bcols": bcols.data_ptr(), "blocks": blocks.data_ptr(), "dy": dY.data_ptr(),
                  "x": X.data_ptr(), "nslots": bcols.numel(), "nbcols": nbcols,
                  "bwidth": bwidth, "bs": bs, "ncols": ncols, "nf": nf,
                  "dtype": _build.VALUE_CODES[str(blocks.dtype).replace("torch.", "")],
                  "stream": None}
        print(f"{label}: {tuple(P.shape)}, bs {bs}, {int((bcols >= 0).sum())} stored of "
              f"{bcols.numel()} slots, nf {nf}", flush=True)
        wants = {"dX": bsr_spmm_t_plain(bcols, blocks, dY, ncols)}
        if not dx_only:
            wants["dB"] = bsr_sddmm_plain(bcols, dY, X, bs)
        for src, lib in libs.items():
            spmm_t, sddmm = entry(src, lib, "repro_bsr_spmm_t"), entry(src, lib, "repro_bsr_sddmm")
            t_buf = scratch(lib, "repro_bsr_spmm_t_scratch", bcols.numel(), nbcols, bs, nf,
                            device=dY.device)
            s_buf = scratch(lib, "repro_bsr_sddmm_scratch", nbcols, device=dY.device)
            keep.append((t_buf, s_buf))
            t_vals = dict(common, scratch=None if t_buf is None else t_buf.data_ptr())
            s_vals = dict(common, scratch=None if s_buf is None else s_buf.data_ptr())

            def launch_t(out, call=spmm_t, vals=t_vals):
                return call(**vals, dx=out.data_ptr())

            def launch_s(out, call=sddmm, vals=s_vals):
                return call(**vals, db=out.data_ptr())

            for kind, want in wants.items():
                launch = launch_t if kind == "dX" else launch_s
                # contiguous: the plain dB is a permuted view
                out, again = (torch.empty(want.shape, device=want.device) for _ in range(2))
                if launch(out) or launch(again):
                    raise SystemExit(f"{kind} {label} {src}: launch failed")
                torch.cuda.synchronize()
                err = (out.double() - want.double()).abs()
                atol = 2e-4 * float(want.abs().max())
                ok = bool((err <= atol + 2e-4 * want.double().abs()).all())
                print(f"check {kind} {label} {src}: within_rtol_2e-4={ok} "
                      f"max_abs_err={float(err.max())} "
                      f"repeat_equal={bool(torch.equal(out, again))}", flush=True)
                if not ok:
                    raise SystemExit(f"{kind} {label} {src}: disagrees with the plain version")
                calls[(f"{kind} {label}", src)] = lambda launch=launch, out=out: launch(out)
        transpose = smoke.bsr_transpose_lib(bcols, blocks, ncols, work)
        calls[(f"dX {label}", TRANSPOSE)] = lambda f=transpose, dY=dY: f(dY)
        if not dx_only:
            sampled, _ = smoke.bsr_sampled_lib(bcols, bs, X, ncols)
            calls[(f"dB {label}", SAMPLED)] = lambda f=sampled, dY=dY: f(dY)
    for (case, src), fn in calls.items():  # a fault shows at the call that made it
        print(f"run {case} {src}", flush=True)
        fn()
        torch.cuda.synchronize()
    time_versions(sources + [TRANSPOSE, SAMPLED], calls)


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    main(sys.argv[1:])
