#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each, each ending with its seconds:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
     and the build of every kernel from ``src/repro_torch/csrc`` (nvcc runs at
     first use; ptxas register and spill lines are printed);
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     shapes of the HPCG 104^3 path: ``scs_spmv`` on the finest level's tiled
     plan, on the resident plan of 52^3 and on the resident plans of the
     tuner's power law and of the block matrix (each with its blocks,
     windows, chunks and real j-steps; the bound counts each entry's id and
     value, x, y, perm and the cached index, ``bound_staged_ms`` what the
     kernel stages, and ``bound_every_slot_ms`` the bound that reads every
     slot),
     ``dia_spmv`` through its dispatch adapter on every HPCG level (104^3,
     52^3, 26^3, 13^3) and masked, on each level, with the first color of
     the masks ``SymGS.build`` makes, against ``where(mask, A @ x, 0)``
     (exact; its bound counts the in-range values of the color's rows, the
     x words they read, the mask and y; its yardstick is cuSPARSE on the
     color's rows with the others left empty),
     ``dia_spmv_tiled`` through its plan adapter on the finest level under
     ``max_resident_cols=1<<18``,
     ``ell_spmv`` on 52^3 and 13^3 with its one-tile index built once, the
     masked ELL wrapper on every 8th row of 52^3 (exact; its bound counts
     the kept rows' id slots and real values, the x words they read, the
     mask and y; its yardstick is cuSPARSE on the kept rows),
     ``ell_spmv_tiled``
     on the finest level's ``"ell-cols"`` plan with its tile index built
     once beforehand (its build seconds, pairs and the bytes the kernel
     stages are printed; the bound counts the real ids and values, x, y and
     the index, and ``bound_every_id_slot_ms`` keeps the bound that reads
     every id slot), ``coo_spmv`` through its container adapter on 13^3 and
     ``scoo_spmv_tiled`` on the finest level's ``"coo-cols"`` plan,
     ``scoo_spmv`` on the finest level's ``build_scoo`` layout (slices and
     blocks of 512; no dispatch path calls it, so its own path here is one
     call, counted like the others), and ``bsr_spmm`` and its masked form on
     the block matrix of phase 8 at 1 and 128 columns (with the path that
     ran: tensor cores or CUDA cores; at 128 columns both paths and the
     plain version are also held against an f64 oracle, on the block matrix
     and on the conformance grid's matrix, at rtol 2e-4 with atol 2e-4).
     Each line gives the
     median kernel time (CUDA events around one call, which also catch the
     wrapper's host time), the kernel's device time alone
     (``torch.profiler``), the plain version's time, one PyTorch library
     call on the same matrix as a yardstick (never called by the port: a
     cuSPARSE CSR SpMV, or for ``bsr_spmm`` ``torch.sparse_bsr_tensor @ X``)
     by events (``library_ms``) and by its device time in every kernel it
     runs (``library_kernel_ms``),
     the bound from the run's own arrays (bytes at 3.35 TB/s against flops
     at 67 TFLOP/s, or for ``bsr_spmm`` at 165 TFLOP/s), and whether two
     launches gave equal bits;
  3. HPCG 16^3 on the card: ``valid`` and ``bitwise``;
  4. the main path, ``run_hpcg(104, 104, 104, iters=50, depth=4, reps=3)``
     racing coo/csr/dia/ell/sell/bsr x plain/cuda (bsr skipped by the
     block-fill guard at every level), with the launch counters and
     the health registry reset just before it and read just after. It
     requires ``bitwise``, ``rel_err < 1e-3``, no failure or non-finite
     output on any key, every cuda candidate timed in the main race, no race
     that lists an error, and ``scs_spmv``, ``dia_spmv``, ``ell_spmv``,
     ``ell_spmv_tiled``, ``coo_spmv`` and ``scoo_spmv_tiled`` launched. Every
     race (the main one and each level's) is printed with its skips;
  5. the path that takes the tiled DIA kernel, counted on its own the same
     way: a column-limited operator (``max_resident_cols=1<<18``) tuned over
     the cuda kernels and solved with CG, which must agree with csr/plain CG
     and launch ``dia_spmv_tiled``;
  6. the run-first tuner on unstructured matrices of 10^6 rows (banded,
     uniform random, power law), each raced through
     ``as_operator(s, device="cuda").tune(...)`` over the same ten keys:
     ``coo/cuda`` must be listed ``unsupported`` (more than 8192 rows, no
     plan), the tuned ``A @ x`` must agree with csr/plain, and a cuda
     winner's kernel must launch for it;
  7. Matrix Market input: every ``tests/fixtures/corpus/*.mtx`` through
     ``repro_torch.io.iter_corpus``, the same race, and ``A @ x`` against
     scipy's ``s @ x``; ``coo_spmv`` must launch on this path;
  8. the block path: ``block_random(65536, 32, 16/2048)`` (34,699 blocks of
     32x32, 35,531,776 entries) through ``as_operator(s, "csr").tune(...)``
     over the same twelve keys (dia skipped by its guard, coo/cuda
     unsupported, bsr/cuda timed), ``A @ x`` and ``A @ X`` (128 columns) of
     the tuned operator and of a bsr operator on the cuda backend against
     csr/plain, the masked bsr SpMV exact, ``bsr_spmm`` launched, and
     ``tune(mode="predict")`` on the same matrix, which launches no kernel;
  9. ``run_hpcg(104, 104, 104, iters=50, depth=4, tune_mode="predict")``:
     phase 3 ranked by the zero-run selector's ``"cuda"`` table, no race;
     ``valid`` and ``bitwise``, its level picks and t_opt.

The line before last is a JSON object with each kernel's numbers
(``launches`` is the count on the path that requires the kernel;
``launches_<path>`` gives every path's count, and ``dia_spmv``'s
``launches_split`` its launches on the two HPCG paths by level, masked or
not); the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero. It needs ``torch.cuda.is_available()`` and the repository's
``src/`` and ``tests/fixtures/corpus`` beside it. Full numbers also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "tests", "fixtures", "corpus")

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 outside the
#: tensor cores — the roofline of a CUDA-core f32 SpMV.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: f32 products on the tensor cores at f32 accuracy: a 3xTF32 split takes
#: three passes at the dense TF32 peak of 495 TFLOP/s (one pass misses rtol
#: 2e-4). The fastest rate at which the card meets ``bsr_spmm``'s tolerance.
TF32X3_FLOPS = 495e12 / 3

#: HPCG's default local grid (the ``hpcg.dat`` of the reference distribution).
GRID = 104
#: The grids of its multigrid levels at depth 4.
LEVELS = (GRID, GRID // 2, GRID // 4, GRID // 8)
#: The ``max_resident_cols`` that sends the 104^3 matrix to the tiled kernels.
COLUMN_LIMIT = 1 << 18

KERNEL_SOURCES = {
    "scs_spmv": ("src/repro_torch/csrc/sell_spmv.cu", "src/repro/kernels/sell_spmv.py:64"),
    "dia_spmv": ("src/repro_torch/csrc/dia_spmv.cu", "src/repro/kernels/dia_spmv.py:58"),
    "dia_spmv_tiled": ("src/repro_torch/csrc/dia_spmv.cu", "src/repro/kernels/dia_spmv.py:135"),
    "ell_spmv": ("src/repro_torch/csrc/ell_spmv.cu", "src/repro/kernels/ell_spmv.py:43"),
    "ell_spmv_tiled": ("src/repro_torch/csrc/ell_spmv.cu", "src/repro/kernels/ell_spmv.py:92"),
    "coo_spmv": ("src/repro_torch/csrc/coo_spmv.cu", "src/repro/kernels/coo_spmv.py:85"),
    "scoo_spmv_tiled": ("src/repro_torch/csrc/coo_spmv.cu",
                        "src/repro/kernels/coo_spmv.py:200"),
    "scoo_spmv": ("src/repro_torch/csrc/coo_spmv.cu", "src/repro/kernels/coo_spmv.py:141"),
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu", "src/repro/kernels/bsr_spmm.py:44"),
}

#: The kernels each format's cuda entry may launch.
FORMAT_KERNELS = {"csr": ("scs_spmv",), "sell": ("scs_spmv",),
                  "dia": ("dia_spmv", "dia_spmv_tiled"),
                  "ell": ("ell_spmv", "ell_spmv_tiled"),
                  "coo": ("coo_spmv", "scoo_spmv_tiled"), "bsr": ("bsr_spmm",)}

#: The reference's DEFAULT_CANDIDATES without dense (n^2 at 104^3).
CANDIDATES = [(fmt, impl) for fmt in ("coo", "csr", "dia", "ell", "sell", "bsr")
              for impl in ("plain", "cuda")]

#: The path on which each kernel must launch: the HPCG run (phase 4), the
#: column-limited CG (phase 5), the one ``scoo_spmv`` call of phase 2 or the
#: block path (phase 8).
REQUIRED_ON = {"scs_spmv": "hpcg", "dia_spmv": "hpcg", "dia_spmv_tiled": "tiled_cg",
               "ell_spmv": "hpcg", "ell_spmv_tiled": "hpcg", "coo_spmv": "hpcg",
               "scoo_spmv_tiled": "hpcg", "scoo_spmv": "scoo", "bsr_spmm": "block"}

#: What a kernel's entry in the JSON line carries beyond the contract's keys:
#: its other shapes (``bsr_spmm``'s SpMM and masked forms, ``scs_spmv`` off
#: the 104^3 plan, DIA at 52^3, 26^3 and 13^3 and masked per level, ELL at
#: 13^3), the path ``bsr_spmm`` ran, and the staged and every-slot bounds.
EXTRA_KEYS = ("path", "masked", "spmm", "coarse", "powerlaw", "block", "shape_52",
              "shape_26", "shape_13",
              "bound_staged_ms", "bound_every_slot_ms", "bound_every_id_slot_ms")

#: The block matrix of the block path: ``block_random(n, bs, density)``.
BLOCK_MATRIX = (65536, 32, 16 / 2048)
#: Columns of X on the block path's SpMM.
BLOCK_NF = 128

#: The unstructured matrices of the tuner phase (10^6 rows: x fits whole,
#: so every format takes its resident strategy).
TUNER_MATRICES = (("banded(10**6, 4)", "banded", (10 ** 6, 4)),
                  ("random_uniform(10**6, 8e-6)", "random_uniform", (10 ** 6, 8e-6)),
                  ("powerlaw(10**6, 8)", "powerlaw", (10 ** 6, 8)))


def phase(label: str, **kv) -> dict:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)
    return kv


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of one ``fn()`` in ms, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time of one ``fn()`` in ms spent in kernels whose name holds
    ``kernel``, from ``torch.profiler`` over ``reps`` calls: the kernel
    alone, without the wrapper's host time that CUDA events around a small
    call also catch. ``None`` when three traces in a row hold no record of
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without the kernel's records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if e.device_type != DeviceType.CPU and kernel in e.key)
        if us > 0:
            return us / reps / 1e3
    return None  # not measured


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved: int, flops: int, flops_per_s: float = F32_FLOPS):
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def color_bytes(offsets, mask, n: int) -> int:
    """Bytes a masked resident DIA call must move (f32 values): the
    in-range stored values of the mask's rows, the distinct x words they
    read, the mask and y (written whole)."""
    import torch

    rows = mask.nonzero().flatten().long()
    seen = torch.zeros(n, dtype=torch.bool, device=mask.device)
    values = 0
    for off in offsets.tolist():
        k = rows + off
        k = k[(k >= 0) & (k < n)]
        values += k.numel()
        seen[k] = True
    return 4 * values + 4 * int(seen.sum()) + n + 4 * n


def within(what: str, y, want, rtol=2e-4) -> float:
    """Max abs error of ``y`` against ``want``, which it must meet at the
    conformance grid's f32 tolerance: rtol 2e-4 with an atol scaled to
    ||want||_inf (sums of a row's products reassociated)."""
    import torch

    y, want = y.double().cpu(), want.double().cpu()
    check(bool(torch.isfinite(y).all()), f"{what}: non-finite output")
    err = (y - want).abs()
    atol = rtol * float(want.abs().max())
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{what}: disagreement beyond rtol {rtol} (max err {float(err.max())})")
    return float(err.max())


def phase_kernels(results: dict, block) -> tuple:
    """Phase 2: every kernel against its plain version at the main path's
    shapes (``block`` is the block path's scipy matrix); returns the
    per-kernel numbers the JSON line reports and the launches of the one
    ``scoo_spmv`` call that is that kernel's path."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.core import ExecutionPolicy, as_operator, matrices as M
    from repro_torch.core.convert import to_bsr, to_coo, to_csr, to_dia, to_ell
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import segment_starts
    from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_path, bsr_spmm_plain
    from repro_torch.kernels.coo_spmv import (build_scoo, coo_spmv_from_container,
                                              coo_spmv_plain, scoo_spmv, scoo_spmv_plain,
                                              scoo_spmv_tiled, scoo_spmv_tiled_plain)
    from repro_torch.kernels.dia_spmv import (dia_spmv_from_container, dia_spmv_plain,
                                              dia_spmv_tiled_from_plan, dia_spmv_tiled_plain)
    from repro_torch.kernels.ell_spmv import (CHUNK_ROWS, ell_spmv, ell_spmv_plain,
                                              ell_spmv_tiled, ell_spmv_tiled_plain,
                                              ell_tile_index)
    from repro_torch.kernels.sell_spmv import scs_spmv_from_plan, scs_spmv_plain
    from repro_torch.solvers.symgs import SymGS

    dev = torch.device("cuda")
    out = {}

    def csr_library(s, x):
        """One cuSPARSE CSR SpMV of ``s`` and ``x``: the yardstick call."""
        A = torch.sparse_csr_tensor(torch.from_numpy(s.indptr.astype(np.int64)),
                                    torch.from_numpy(s.indices.astype(np.int64)),
                                    torch.from_numpy(s.data.astype(np.float32)),
                                    size=s.shape).to(dev)
        return lambda: A @ x

    def vec(n):
        return torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                                .astype(np.float32)).to(dev)

    def measure(name, label, s, x, fn, plain, moved, kernel, plain_reps=5, exact=False,
                flops=None, flops_per_s=F32_FLOPS, library=None, **extra):
        """Kernel against plain (exactly when ``exact``), two launches
        bit-equal, then the times; ``moved`` is the bytes the function must
        move for this input, ``flops`` its operations (default two per
        nonzero) at ``flops_per_s``, ``kernel`` the CUDA kernel's name,
        ``library`` the yardstick call (default a cuSPARSE CSR SpMV of ``s``
        and ``x``; ``False``: none), timed by events (``library_ms``) and by
        its device time in every kernel it runs (``library_kernel_ms``)."""
        y, y_plain = fn(), plain()
        err = within(f"{label} against its plain version", y, y_plain)
        same = bool(torch.equal(y, y_plain))
        if exact:
            check(same, f"{label}: kernel differs from its plain version")
        check(bool(torch.equal(y, fn())), f"{label}: two launches differ")
        b_ms, b_by = bound(moved, 2 * s.nnz if flops is None else flops, flops_per_s)
        lib = csr_library(s, x) if library is None else library
        rec = dict(extra, exact=same, repeat_equal=True, max_abs_err=err,
                   ms=cuda_ms(fn, 50), kernel_ms=kernel_ms(fn, kernel),
                   plain_ms=cuda_ms(plain, plain_reps),
                   library_ms=cuda_ms(lib, reps=20) if lib else None,
                   library_kernel_ms=kernel_ms(lib, "") if lib else None,
                   bytes=moved, flops=2 * s.nnz if flops is None else flops,
                   bound_ms=b_ms, bound_by=b_by)
        del lib
        results[name] = phase(f"kernel {label}", **rec)
        return rec

    def scs_row(name, label, s, x, **extra):
        """``scs_spmv`` on ``s``'s csr plan through the dispatch adapter
        (real j-steps and work list cached on the plan). The bound counts
        what the function needs: each entry's id and value, x, y, perm and
        the cached index. ``bound_staged_ms`` counts what the kernel stages
        (every slot of the real j-steps, their slices, each block's tile),
        ``bound_every_slot_ms`` every slot of the plan, padding included."""
        n = s.shape[0]
        A = to_csr(s, device=dev)
        plan = A.plan
        btile, bwin, lsl, idx2, dat2, perm = plan.arrays
        ct, ntiles, C, sw, jb, nwin = plan.meta
        y = scs_spmv_from_plan(plan, x, nrows=n)  # fills the plan's cache
        nreal, work = plan.cache["nreal"], plan.cache["work"]
        real = int(nreal.sum())
        runs = segment_starts(bwin, nwin)
        rest = nbytes(x, perm, nreal, *work[:4]) + n * 4
        needed = s.nnz * (idx2.element_size() + dat2.element_size()) + rest
        staged = real * (C * (idx2.element_size() + dat2.element_size()) + 4) + rest + nbytes(
            btile)
        del y
        return measure(
            name, label, s, x, lambda: scs_spmv_from_plan(plan, x, nrows=n),
            lambda: scs_spmv_plain(*plan.arrays, x, nrows=n, col_tile=ct, ntiles=ntiles,
                                   C=C, sw=sw, jb=jb, nwin=nwin),
            needed, "scs_", plain_reps=3, strategy=ops.cuda_strategy(A, ExecutionPolicy()),
            ntiles=ntiles, blocks=int(btile.shape[0]), windows=nwin,
            longest_window_blocks=int((runs[1:] - runs[:-1]).max()),
            chunks=int(work.chunk_win.shape[0]), chunk_blocks=work.chunk_blocks,
            split_windows=int(work.split_win.shape[0]), real_jsteps=real,
            jstep_slots=int(idx2.shape[0]), index_dtype=str(idx2.dtype),
            bound_staged_ms=bound(staged, 2 * s.nnz)[0],
            bound_every_slot_ms=bound(nbytes(btile, lsl, idx2, dat2, perm, runs, x) + n * 4,
                                      2 * s.nnz)[0], **extra)

    mats = {g: M.fdm27(g, g, g) for g in LEVELS}
    out["scs_spmv"] = scs_row("scs_spmv_finest", f"scs_spmv finest {GRID}^3", mats[GRID],
                              vec(mats[GRID].shape[0]), grid=GRID)
    others = {"coarse": (f"scs_spmv coarse {GRID // 2}^3", mats[GRID // 2]),
              "powerlaw": ("scs_spmv powerlaw(10**6, 8)", M.powerlaw(10 ** 6, 8)),
              "block": ("scs_spmv block_random(65536, 32, 16/2048)", block)}
    for key, (label, s) in others.items():
        rec = scs_row(f"scs_spmv_{key}", label, s, vec(s.shape[0]))
        out["scs_spmv"][key] = {k: rec[k] for k in (
            "max_abs_err", "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms",
            "bound_ms",
            "bound_staged_ms", "bound_every_slot_ms", "blocks", "windows", "chunks",
            "real_jsteps")}
        del s
    torch.cuda.empty_cache()

    # resident DIA at every HPCG level, and masked on one SymGS color of each
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
    zero = torch.zeros((), device=dev)
    for g in LEVELS:
        sg = mats[g]
        ng = sg.shape[0]
        xg = vec(ng)
        D = to_dia(sg, device=dev)
        rec = measure(
            f"dia_spmv_{g}", f"dia_spmv {g}^3", sg, xg,
            lambda: dia_spmv_from_container(D, xg), lambda: dia_spmv_plain(D.offsets, D.data, xg),
            nbytes(D.offsets, D.data, xg) + ng * 4, "dia_resident_kernel", exact=True,
            grid=g, strategy=ops.cuda_strategy(D, ExecutionPolicy()), ndiags=D.ndiags)
        if g == GRID:
            out["dia_spmv"] = rec
        else:
            out["dia_spmv"][f"shape_{g}"] = {k: rec[k] for k in (
                "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms", "bound_ms",
                "bound_by")}
        # the masks SymGS.build makes (the greedy coloring's classes); the first
        mask = SymGS.build(sg, operator=as_operator(D)).masks[0]
        ym = ops.dia_masked_spmv_cuda(D, xg, mask, pol)
        check(bool(torch.equal(ym, torch.where(mask, ops.dia_spmv_cuda(D, xg, pol), zero))),
              f"masked DIA {g}^3 != where(mask, A @ x, 0)")
        rows = mask.nonzero().flatten().cpu().numpy()
        # yardstick: cuSPARSE on the color's rows, the other rows left empty
        sm = sp.csr_matrix(sp.diags(mask.cpu().numpy().astype(np.float64)) @ sg)
        rec = measure(
            f"dia_masked_{g}", f"dia_spmv masked {g}^3 (one SymGS color)", sg, xg,
            lambda: ops.dia_masked_spmv_cuda(D, xg, mask, pol),
            lambda: dia_spmv_plain(D.offsets, D.data, xg, mask),
            color_bytes(D.offsets, mask, ng), "dia_resident_kernel", exact=True,
            flops=2 * int(sm.nnz), library=csr_library(sm, xg), grid=g,
            color_rows=int(rows.size), equals_where_of_unmasked=True)
        out["dia_spmv"].setdefault("masked", {})[f"{g}^3"] = {k: rec[k] for k in (
            "color_rows", "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms",
            "bound_ms", "bound_by", "bytes")}
        del D, sm
    s, n = mats[GRID], mats[GRID].shape[0]
    x = vec(n)

    tpol = ExecutionPolicy(max_resident_cols=COLUMN_LIMIT)
    DT = to_dia(s, col_tile=tpol.col_tile(n), device=dev)
    check(ops.cuda_strategy(DT, tpol) == "tiled", "dia under the column limit is not tiled")
    offs_t, dat_w = DT.plan.arrays
    ct_d = DT.plan.ct
    out["dia_spmv_tiled"] = measure(
        "dia_spmv_tiled", f"dia_spmv_tiled {GRID}^3", s, x,
        lambda: dia_spmv_tiled_from_plan(DT.plan, x, n),
        lambda: dia_spmv_tiled_plain(offs_t, dat_w, x, nrows=n, col_tile=ct_d),
        nbytes(offs_t, dat_w, x) + n * 4, "dia_tiled_kernel", plain_reps=3, exact=True,
        grid=GRID, strategy="tiled", max_resident_cols=tpol.max_resident_cols, ct=ct_d,
        ntiles=DT.plan.ntiles, max_d=int(offs_t.shape[1]))
    del DT, offs_t, dat_w

    # ELL: resident on 52^3, the masked wrapper, tiled on the finest level
    g = GRID // 2
    s52 = mats[g]
    n52 = s52.shape[0]
    x52 = vec(n52)
    E = to_ell(s52, device=dev)
    check(ops.cuda_strategy(E, ExecutionPolicy()) == "resident", "ell 52^3 is not resident")
    valid = int((E.indices >= 0).sum())
    listed52 = ell_tile_index(E.indices.unsqueeze(0))
    out["ell_spmv"] = measure(
        "ell_spmv", f"ell_spmv {g}^3", s52, x52,
        lambda: ell_spmv(E.indices, E.data, x52, tile_index=listed52),
        lambda: ell_spmv_plain(E.indices, E.data, x52),
        nbytes(E.indices, x52, *listed52[:2]) + valid * E.data.element_size() + n52 * 4,
        "ell_listed_kernel", exact=True, grid=g, strategy="resident", width=E.width)
    mask52 = torch.from_numpy((np.arange(n52) % 8) == 3).to(dev)
    ym = ops.ell_masked_spmv_cuda(E, x52, mask52, pol)
    want = torch.where(mask52, ops.ell_spmv_cuda(E, x52, pol), torch.zeros((), device=dev))
    check(bool(torch.equal(ym, want)), "masked ELL != where(mask, A @ x, 0)")
    # its bound: the kept rows' id slots and real values, the x words they
    # read, the mask and y; its yardstick cuSPARSE on the kept rows alone
    kept_ids = E.indices[mask52]
    kept_real = kept_ids[kept_ids >= 0].long()
    seen = torch.zeros(n52, dtype=torch.bool, device=dev)
    seen[kept_real] = True
    sm52 = sp.csr_matrix(sp.diags(mask52.cpu().numpy().astype(np.float64)) @ s52)
    out["ell_spmv"]["masked"] = {k: v for k, v in measure(
        "ell_masked", f"ell_spmv masked {g}^3 (every 8th row)", s52, x52,
        lambda: ops.ell_masked_spmv_cuda(E, x52, mask52, pol),
        lambda: ell_spmv_plain(E.indices, E.data, x52, mask52),
        nbytes(kept_ids, x52[seen], mask52, *listed52[:2]) + kept_real.numel()
        * E.data.element_size() + n52 * 4,
        "ell_listed_kernel", exact=True, flops=2 * int(sm52.nnz),
        library=csr_library(sm52, x52), kept_rows=int(mask52.sum()),
        equals_where_of_unmasked=True).items() if k in (
        "kept_rows", "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms",
        "bound_ms", "bound_by", "bytes")}
    del E, kept_ids, kept_real, seen, sm52

    E = to_ell(s, device=dev)
    check(ops.cuda_strategy(E, ExecutionPolicy()) == "tiled", "ell 104^3 is not tiled")
    idx_t, dat_t = E.plan.arrays
    ct_e, width = E.plan.ct, int(idx_t.shape[2])
    valid = int((idx_t >= 0).sum())
    slots = idx_t.numel()
    torch.cuda.synchronize()
    t_index = time.perf_counter()
    listed = ell_tile_index(idx_t)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t_index
    tile_ptr, tile_ids, _ = listed
    chunk_rows = torch.full((tile_ptr.shape[0] - 1,), CHUNK_ROWS, device=dev)
    chunk_rows[-1] = n - CHUNK_ROWS * (chunk_rows.shape[0] - 1)
    staged = int(((tile_ptr[1:] - tile_ptr[:-1]) * chunk_rows).sum()) * width * (
        idx_t.element_size() + dat_t.element_size())
    out["ell_spmv_tiled"] = measure(
        "ell_spmv_tiled", f"ell_spmv_tiled {GRID}^3", s, x,
        lambda: ell_spmv_tiled(idx_t, dat_t, x, col_tile=ct_e, tile_index=listed),
        lambda: ell_spmv_tiled_plain(idx_t, dat_t, x, col_tile=ct_e),
        valid * (idx_t.element_size() + dat_t.element_size())
        + nbytes(x, tile_ptr, tile_ids) + n * 4,
        "ell_listed_kernel", plain_reps=3, exact=True,
        grid=GRID, strategy="tiled", ct=ct_e, ntiles=E.plan.ntiles, width=width,
        index_dtype=str(idx_t.dtype), slots=slots, nonzeros=valid, padding=slots / valid,
        pairs=int(tile_ids.shape[0]), chunks=int(tile_ptr.shape[0] - 1),
        tile_index_build_s=t_index, staged_bytes=staged,
        bound_every_id_slot_ms=bound(nbytes(idx_t, x) + valid * dat_t.element_size() + n * 4,
                                     2 * s.nnz)[0],
        bound_all_ms=bound(nbytes(idx_t, dat_t, x) + n * 4, 2 * s.nnz)[0])
    del E, idx_t, dat_t, listed, tile_ptr, tile_ids

    # ELL at 13^3, the level where HPCG launches ell_spmv most
    g = GRID // 8
    s13 = mats[g]
    n13 = s13.shape[0]
    x13 = vec(n13)
    E = to_ell(s13, device=dev)
    listed13 = ell_tile_index(E.indices.unsqueeze(0))
    valid = int((E.indices >= 0).sum())
    rec = measure(
        "ell_spmv_13", f"ell_spmv {g}^3", s13, x13,
        lambda: ell_spmv(E.indices, E.data, x13, tile_index=listed13),
        lambda: ell_spmv_plain(E.indices, E.data, x13),
        nbytes(E.indices, x13, *listed13[:2]) + valid * E.data.element_size() + n13 * 4,
        "ell_listed_kernel", exact=True, grid=g, width=E.width)
    out["ell_spmv"]["shape_13"] = {k: rec[k] for k in (
        "ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms", "bound_ms",
        "bound_by")}
    del E

    # COO: full window on 13^3, sliced on the finest level
    Co = to_coo(s13, device=dev)
    check(ops.cuda_strategy(Co, ExecutionPolicy()) == "resident", "coo 13^3 is not resident")
    coo_spmv_from_container(Co, x13)  # checks Co and keeps its segment starts
    starts = Co.cache["rows"].row_start
    out["coo_spmv"] = measure(
        "coo_spmv", f"coo_spmv {g}^3", s13, x13,
        lambda: coo_spmv_from_container(Co, x13),
        lambda: coo_spmv_plain(Co.row, Co.col, Co.val, x13, nrows=n13),
        nbytes(starts, Co.col, Co.val, x13) + n13 * 4, "coo_rows_kernel", exact=True,
        grid=g, strategy="resident")
    del Co, starts

    Co = to_coo(s, device=dev)
    check(ops.cuda_strategy(Co, ExecutionPolicy()) == "tiled", "coo 104^3 is not tiled")
    row, col, val, sid, ctile = Co.plan.arrays
    ct_c, ntiles_c, slice_rows, tile = Co.plan.meta
    runs = segment_starts(sid, -(-n // slice_rows))
    out["scoo_spmv_tiled"] = measure(
        "scoo_spmv_tiled", f"scoo_spmv_tiled {GRID}^3", s, x,
        lambda: scoo_spmv_tiled(row, col, val, sid, ctile, x, nrows=n, col_tile=ct_c,
                                slice_rows=slice_rows, tile=tile, run_start=runs),
        lambda: scoo_spmv_tiled_plain(row, col, val, sid, ctile, x, nrows=n, col_tile=ct_c,
                                      tile=tile),
        nbytes(row, col, val, ctile, runs, x) + n * 4, "scoo_tiled_kernel",
        grid=GRID, strategy="tiled", ct=ct_c, ntiles=ntiles_c, slice_rows=slice_rows,
        tile=tile, blocks=int(sid.shape[0]), entries=int(row.shape[0]),
        index_dtype=str(col.dtype))
    del Co, row, col, val, sid, ctile, runs

    # a group of two entries: the slice's first row, another row and the pad
    # run (rows = the slice's first row) share one warp step
    dense = np.zeros((512, 128))
    dense[:, :64] = np.random.default_rng(19).standard_normal((512, 64)) * (
        np.arange(512 * 64).reshape(512, 64) % 17 == 0)
    dense[0, 100], dense[1, 100] = 1.5, -2.0
    Co = to_coo(sp.csr_matrix(dense), col_tile=64, device=dev)
    xs = vec(128)
    ct_c, _, slice_rows, tile = Co.plan.meta
    ys = scoo_spmv_tiled(*Co.plan.arrays, xs, nrows=512, col_tile=ct_c,
                         slice_rows=slice_rows, tile=tile)
    within("scoo_spmv_tiled beside a pad run against its plain version", ys,
           scoo_spmv_tiled_plain(*Co.plan.arrays, xs, nrows=512, col_tile=ct_c, tile=tile))
    del Co

    # scoo_spmv on the finest level's build_scoo layout (row-sorted COO)
    coo = s.tocoo()
    srow, scol, sval, ssid = (torch.from_numpy(a).to(dev) for a in build_scoo(
        coo.row, coo.col, coo.data.astype(np.float32), n, slice_rows=512, tile=512))
    del coo
    sruns = segment_starts(ssid, -(-n // 512))
    out["scoo_spmv"] = measure(
        "scoo_spmv", f"scoo_spmv {GRID}^3", s, x,
        lambda: scoo_spmv(srow, scol, sval, ssid, x, nrows=n, run_start=sruns),
        lambda: scoo_spmv_plain(srow, scol, sval, ssid, x, nrows=n),
        nbytes(srow, scol, sval, sruns, x) + n * 4, "scoo_tiled_kernel",
        grid=GRID, slice_rows=512, tile=512, blocks=int(ssid.shape[0]),
        entries=int(srow.shape[0]))
    want = torch.from_numpy(s @ x.double().cpu().numpy())

    def scoo_path():
        y = scoo_spmv(srow, scol, sval, ssid, x, nrows=n)
        within(f"scoo_spmv {GRID}^3 against scipy", y, want)

    _, launches_scoo, _ = counted("scoo", scoo_path)
    del srow, scol, sval, ssid, sruns
    torch.cuda.empty_cache()

    def bsr_f64_errors(label, sm, B, X):
        """``bsr_spmm`` on the tensor cores (X whole), on the CUDA cores (X a
        column at a time) and its plain version, each against an f64 oracle
        (the stored f32 values and X in f64, a cuSPARSE product on the card):
        the max abs error and the largest ratio of the error to the
        conformance grid's f32 tolerance ``2e-4 + 2e-4 * |y|``."""
        c = sp.csr_matrix(sm)
        A64 = torch.sparse_csr_tensor(
            torch.from_numpy(c.indptr.astype(np.int64)),
            torch.from_numpy(c.indices.astype(np.int64)),
            torch.from_numpy(c.data.astype(np.float32).astype(np.float64)),
            size=c.shape).to(dev)
        n = c.shape[0]
        want = A64 @ X.double()
        check(bsr_spmm_path(B.bs, X.shape[1]) == "tensor-core",
              f"bsr {label}: {X.shape[1]} columns do not take the tensor cores")
        ys = {"tensor_core": bsr_spmm(B.bcols, B.blocks, X),
              "cuda_core": torch.cat([bsr_spmm(B.bcols, B.blocks, X[:, j:j + 1].contiguous())
                                      for j in range(X.shape[1])], 1),
              "plain": bsr_spmm_plain(B.bcols, B.blocks, X)}
        errs = {}
        for path, y in ys.items():
            err = (y[:n].double() - want).abs()
            errs[path] = dict(max_abs_err=float(err.max()), tol_ratio=float(
                (err / (2e-4 + 2e-4 * want.abs())).max()))
        phase(f"bsr_spmm f64 oracle, {label}, {X.shape[1]} columns", **{
            f"{p}_{k}": v for p, e in errs.items() for k, v in e.items()})
        check(errs["tensor_core"]["tol_ratio"] <= 1 and errs["cuda_core"]["tol_ratio"] <= 1,
              f"bsr {label}: a path misses rtol 2e-4 with atol 2e-4 against f64: {errs}")
        return errs

    # bsr_spmm and its masked form on the block matrix, one and 128 columns
    B = to_bsr(block, device=dev)
    nb = block.shape[0]
    bs, esz = B.bs, B.blocks.element_size()
    valid = B.bcols >= 0
    real = int(valid.sum())
    bsr_lib = torch.sparse_bsr_tensor(
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), valid.sum(1).cumsum(0)]),
        B.bcols[valid].long(), B.blocks[valid], size=block.shape)
    mask = torch.from_numpy((np.arange(nb) % 8) == 3).to(dev)
    kept = mask.reshape(-1, bs).sum(1)  # kept rows of each block row
    kept_entries = int((valid.sum(1) * kept).sum()) * bs  # stored entries they read

    for nf in (1, BLOCK_NF):
        X = torch.from_numpy(np.random.default_rng(3).standard_normal((nb, nf))
                             .astype(np.float32)).to(dev)
        Y = bsr_spmm(B.bcols, B.blocks, X)
        rec = measure(
            f"bsr_spmm_nf{nf}", f"bsr_spmm nf={nf}", block, X,
            lambda: bsr_spmm(B.bcols, B.blocks, X), lambda: bsr_spmm_plain(B.bcols, B.blocks, X),
            real * bs * bs * esz + nbytes(B.bcols, X) + nb * nf * 4, "bsr_spmm_",
            plain_reps=3, flops=2 * real * bs * bs * nf, flops_per_s=TF32X3_FLOPS,
            library=lambda X=X: bsr_lib @ X, nf=nf, path=bsr_spmm_path(bs, nf), bs=bs,
            bwidth=B.bwidth, real_blocks=real,
            padded_blocks=int(valid.numel()))
        Ym = bsr_spmm(B.bcols, B.blocks, X, row_mask=mask)
        check(bool(torch.equal(Ym, torch.where(mask[:, None], Y, torch.zeros((), device=dev)))),
              f"masked bsr_spmm nf={nf} != where(mask, A @ X, 0)")
        recm = measure(
            f"bsr_masked_nf{nf}", f"bsr_spmm masked nf={nf}", block, X,
            lambda: bsr_spmm(B.bcols, B.blocks, X, row_mask=mask),
            lambda: bsr_spmm_plain(B.bcols, B.blocks, X, row_mask=mask),
            kept_entries * esz + nbytes(B.bcols, X, mask) + nb * nf * 4,
            "bsr_spmm_", plain_reps=3, flops=2 * kept_entries * nf,
            flops_per_s=TF32X3_FLOPS, library=False, nf=nf, path=bsr_spmm_path(bs, nf),
            equals_where_of_unmasked=True)
        masked = {k: recm[k] for k in (
            "nf", "path", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
        if nf == BLOCK_NF:
            rec["f64"] = bsr_f64_errors("block", block, B, X)
            sgrid = M.banded(96, 3, seed=0) + M.random_uniform(96, 0.02, seed=1)
            Xg = torch.from_numpy(np.random.default_rng(10).standard_normal((96, nf))
                                  .astype(np.float32)).to(dev)
            rec["f64_grid"] = bsr_f64_errors("conformance grid", sgrid,
                                             to_bsr(sgrid, device=dev), Xg)
        if nf == 1:
            out["bsr_spmm"] = dict(rec, masked=masked)
        else:
            out["bsr_spmm"]["spmm"] = {k: rec[k] for k in (
                "nf", "path", "max_abs_err", "ms", "kernel_ms", "plain_ms", "library_ms",
                "library_kernel_ms", "bound_ms", "bound_by", "f64", "f64_grid")}
            out["bsr_spmm"]["spmm"]["masked"] = masked
        del X, Y, Ym
    del B, bsr_lib
    torch.cuda.empty_cache()
    return out, launches_scoo


def counters() -> dict:
    """Every kernel wrapper by name."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.coo_spmv import coo_spmv, scoo_spmv, scoo_spmv_tiled
    from repro_torch.kernels.dia_spmv import dia_spmv, dia_spmv_tiled
    from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_tiled
    from repro_torch.kernels.sell_spmv import scs_spmv

    return {"scs_spmv": scs_spmv, "dia_spmv": dia_spmv, "dia_spmv_tiled": dia_spmv_tiled,
            "ell_spmv": ell_spmv, "ell_spmv_tiled": ell_spmv_tiled, "coo_spmv": coo_spmv,
            "scoo_spmv_tiled": scoo_spmv_tiled, "scoo_spmv": scoo_spmv, "bsr_spmm": bsr_spmm}


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def dia_split(by_shape) -> dict:
    """``dia_spmv``'s launches by level (``g^3`` for a cube of g^3 rows,
    else the row count) and by masked or not."""
    out = {}
    for (rows, masked), count in sorted(by_shape.items(), reverse=True):
        g = round(rows ** (1 / 3))
        out.setdefault(f"{g}^3" if g ** 3 == rows else str(rows), {})[
            "masked" if masked else "unmasked"] = count
    return out


@contextlib.contextmanager
def recorded_races(log: list):
    """Record every ``autotune_spmv`` race (the main one, each multigrid
    level's, each ``tune()``) with the matrix shape it raced on."""
    import repro_torch.apps.hpcg as hpcg_mod
    import repro_torch.core.autotune as tune_mod
    import repro_torch.solvers.mg as mg_mod

    orig = tune_mod.autotune_spmv

    def recording(*args, **kwargs):
        res = orig(*args, **kwargs)
        log.append(res)
        return res

    mods = (tune_mod, mg_mod, hpcg_mod)
    for m in mods:
        m.autotune_spmv = recording
    try:
        yield log
    finally:
        for m in mods:
            m.autotune_spmv = orig


def print_race(label: str, res) -> None:
    table = {f"{f}/{i}": round(t, 1) for (f, i), t in sorted(res.table.items(),
                                                               key=lambda kv: kv[1])}
    phase(f"{label} race", shape=tuple(res.matrix.shape), chosen=f"{res.format}/{res.impl}",
          table_us=json.dumps(table), skipped=json.dumps(res.skipped))


def counted(label: str, drive):
    """Run ``drive()`` with every launch counter and the health registry
    reset just before it; read both just after. Fails on any failure or
    non-finite output of any key, and on any race that lists an error.
    Returns (drive's value, launches, races)."""
    from repro_torch.core import health_registry

    for fn in counters().values():
        fn.launches = 0
    dia = counters()["dia_spmv"]
    dia.by_shape.clear()
    health_registry().reset()
    races = []
    with recorded_races(races):
        value = drive()
    launches = launch_counts()
    launches["dia_spmv_split"] = dia_split(dia.by_shape)
    faults = {k: v for k, v in health_registry().snapshot()["keys"].items()
              if v["failures"] or v["nonfinite"]}
    phase(f"{label} counts", launches=json.dumps(launches), faults=json.dumps(faults),
          races=len(races))
    check(not faults, f"{label}: keys failed or went non-finite: {faults}")
    errs = [(tuple(r.matrix.shape), sk) for r in races for sk in r.skipped
            if sk[2].startswith("error:")]
    check(not errs, f"{label}: races listed errors: {errs}")
    return value, launches, races


def check_bsr_guarded(label: str, skipped) -> None:
    """bsr is in the race and skipped by the block-fill guard (an HPCG
    level's 32-edge blocks are under an eighth full)."""
    for impl in ("plain", "cuda"):
        check(any(sk[:2] == ("bsr", impl) and sk[2].startswith("block_fill=")
                  for sk in skipped), f"{label}: bsr/{impl} not skipped by the block-fill guard")


def check_hpcg(res, label: str) -> None:
    check(res.bitwise, f"{label}: bitwise tier failed")
    check(res.rel_err < 1e-3, f"{label}: rel_err {res.rel_err} >= 1e-3")
    for fmt, impl in CANDIDATES:
        if impl == "cuda" and fmt != "bsr":
            check(f"{fmt}/{impl}" in res.table, f"{label}: {fmt}/cuda missing from the tune table")
    check_bsr_guarded(label, res.skipped)
    errs = [sk for sk in res.skipped if sk[2].startswith("error:")]
    check(not errs, f"{label}: candidates raised: {errs}")


def phase_tuner(results: dict):
    """Phase 6: the run-first tuner on unstructured matrices of 10^6 rows."""
    import numpy as np
    import torch

    from repro_torch.core import as_operator
    from repro_torch.core import matrices as M

    out = {}
    for label, gen, args in TUNER_MATRICES:
        s = getattr(M, gen)(*args)
        n = s.shape[0]
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                             .astype(np.float32)).cuda()
        races = []
        with recorded_races(races):
            tuned = as_operator(s, device="cuda").tune(candidates=CANDIDATES)
        res = races[-1]
        print_race(f"tuner {label}", res)
        check(("coo", "cuda", "unsupported") in res.skipped and ("coo", "cuda") not in res.table,
              f"tuner {label}: coo/cuda was not listed unsupported")
        before = launch_counts()
        y = tuned @ x
        torch.cuda.synchronize()
        after = launch_counts()
        if res.impl == "cuda":
            ran = sum(after[k] - before[k] for k in FORMAT_KERNELS[res.format])
            check(ran == 1, f"tuner {label}: the winner {res.format}/cuda launched {ran} kernels")
        want = as_operator(s, "csr", device="cuda").using("plain") @ x
        err = within(f"tuner {label}: tuned A @ x against csr/plain", y, want)
        out[label] = phase(f"tuner {label}", nnz=s.nnz, chosen=f"{res.format}/{res.impl}",
                           max_abs_err=err)
        del s, tuned, x, y, want
    results["tuner"] = out


def phase_corpus(results: dict):
    """Phase 7: Matrix Market input through ``repro_torch.io``."""
    import numpy as np
    import torch

    from repro_torch.core import as_operator
    from repro_torch.io import iter_corpus

    out = {}
    names = []
    for name, s in iter_corpus(CORPUS):
        names.append(name)
        x = np.random.default_rng(2).standard_normal(s.shape[1])
        races = []
        with recorded_races(races):
            tuned = as_operator(s, device="cuda").tune(candidates=CANDIDATES)
        print_race(f"corpus {name}", races[-1])
        y = tuned @ torch.from_numpy(x.astype(np.float32)).cuda()
        err = within(f"corpus {name}: tuned A @ x against scipy", y,
                     torch.from_numpy(s @ x))
        out[name] = phase(f"corpus {name}", shape=s.shape, nnz=s.nnz,
                          chosen=f"{tuned.format}/{tuned.policy.backends[0]}",
                          max_abs_err=err)
    check(len(names) >= 5, f"corpus: only {names} read from {CORPUS}")
    results["corpus"] = out


def phase_block(results: dict, block):
    """Phase 8: the block path — a block-structured operator tuned, then
    applied to one and to BLOCK_NF right-hand sides, on the cuda backend's
    bsr entry; and the zero-run pick on the same matrix."""
    import numpy as np
    import torch

    from repro_torch.core import as_operator, health_registry

    n = block.shape[0]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    X = torch.from_numpy(rng.standard_normal((n, BLOCK_NF)).astype(np.float32)).cuda()
    mask = torch.from_numpy((np.arange(n) % 8) == 3).cuda()
    A = as_operator(block, "csr", device="cuda")
    races = []
    with recorded_races(races):
        tuned = A.tune(candidates=CANDIDATES)
    res = races[-1]
    print_race("block", res)
    check(("bsr", "cuda") in res.table, "block: bsr/cuda was not timed in the race")
    check(("coo", "cuda", "unsupported") in res.skipped, "block: coo/cuda not unsupported")
    ref = A.using("plain")
    want_y, want_Y = ref @ x, ref @ X
    B = tuned if (res.format, res.impl) == ("bsr", "cuda") else A.asformat("bsr").using("cuda")
    errs = {}
    for label, op in (("tuned", tuned), ("bsr/cuda", B)):
        before = launch_counts()["bsr_spmm"]
        y, Y = op @ x, op @ X
        torch.cuda.synchronize()
        ran = launch_counts()["bsr_spmm"] - before
        errs[label] = (within(f"block: {label} A @ x against csr/plain", y, want_y),
                       within(f"block: {label} A @ X against csr/plain", Y, want_Y))
        if label == "bsr/cuda":
            check(ran == 2, f"block: bsr/cuda launched bsr_spmm {ran} times for A @ x, A @ X")
            ym = op.masked_matvec(x, mask)
            check(bool(torch.equal(ym, torch.where(mask, y, torch.zeros((), device="cuda")))),
                  "block: masked bsr SpMV != where(mask, A @ x, 0)")
    before, faults = launch_counts(), health_registry().snapshot()["keys"]
    t0 = time.perf_counter()
    P = A.tune(candidates=CANDIDATES, mode="predict")
    predict_s = time.perf_counter() - t0
    check(launch_counts() == before and health_registry().snapshot()["keys"] == faults,
          "block: tune(mode='predict') launched a kernel")
    results["block"] = phase(
        "block", n=n, nnz=block.nnz, race=f"{res.format}/{res.impl}",
        predict=f"{P.format}/{P.policy.backends[0]}", predict_s=round(predict_s, 2),
        max_abs_err=json.dumps(errs))
    del A, tuned, B, P, ref


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.apps.hpcg import run_hpcg
    from repro_torch.core import ExecutionPolicy, as_operator
    from repro_torch.core import matrices as M
    from repro_torch.kernels._build import library
    from repro_torch.solvers import cg

    t_start = time.perf_counter()
    results = {}
    seconds = {}
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        seconds[name] = round(time.perf_counter() - t0, 1)
        phase(f"phase {name}", seconds=seconds[name])
        t0 = time.perf_counter()

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    results["device"] = phase(
        "device", smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        build_s=round(lib.seconds, 2))
    torch.backends.cuda.matmul.allow_tf32 = False  # the cuSPARSE yardstick in full f32
    lap("1 build")

    # ---------------------------------------------------------------- 2
    block = M.block_random(BLOCK_MATRIX[0], BLOCK_MATRIX[1], block_density=BLOCK_MATRIX[2],
                           seed=0)
    kern, launches_scoo = phase_kernels(results, block)
    lap("2 kernels")

    # ---------------------------------------------------------------- 3
    r16 = run_hpcg(16, 16, 16, iters=50, timed=False, candidates=CANDIDATES, device="cuda")
    check(r16.valid and r16.bitwise, f"HPCG 16^3: valid={r16.valid} bitwise={r16.bitwise}")
    results["hpcg16"] = phase("hpcg 16^3", valid=r16.valid, bitwise=r16.bitwise,
                              pcg_iters=r16.pcg_iters, rel_res=r16.rel_res,
                              levels=repr(r16.mg_levels))
    lap("3 hpcg16")

    # ---------------------------------------------------------------- 4
    g = GRID
    res, launches_hpcg, races = counted(f"hpcg {g}^3", lambda: run_hpcg(
        g, g, g, iters=50, depth=4, reps=3, candidates=CANDIDATES, device="cuda"))
    for r in races:
        if len(r.table) > 1:  # the validation races time csr/plain alone
            print_race(f"hpcg {g}^3", r)
            check_bsr_guarded(f"HPCG {g}^3 race at {tuple(r.matrix.shape)}", r.skipped)
    check_hpcg(res, f"HPCG {g}^3")
    results["hpcg"] = phase(
        f"hpcg {g}^3", valid=res.valid, bitwise=res.bitwise, rel_err=res.rel_err,
        pcg_iters=res.pcg_iters, rel_res=res.rel_res,
        converged=res.rel_res <= 1e-6, chosen=res.chosen, levels=repr(res.mg_levels),
        t_ref_s=res.ref_time_s, t_opt_s=res.opt_time_s,
        launches=json.dumps(launches_hpcg), table=json.dumps(res.table),
        skipped=json.dumps(res.skipped))
    lap("4 hpcg104")

    # ---------------------------------------------------------------- 5
    # the column-limited operator: tiled plans, tuned over the cuda kernels
    A_sp = M.fdm27(g, g, g)
    n = A_sp.shape[0]
    b = torch.from_numpy((A_sp @ np.ones(n)).astype(np.float32)).cuda()
    tpol = ExecutionPolicy(max_resident_cols=COLUMN_LIMIT)
    A_tiled = as_operator(A_sp, "csr", policy=tpol, device="cuda")

    def tiled_cg():
        tuned = A_tiled.tune(candidates=[("dia", "cuda"), ("csr", "cuda"),
                                         ("sell", "cuda"), ("csr", "plain")])
        return tuned, cg(tuned, b, tol=1e-6, maxiter=50)

    (tuned, info), launches_tiled, _ = counted(f"cg {g}^3 column-limited", tiled_cg)
    ref = cg(as_operator(A_sp, "csr", device="cuda").using("plain"), b, tol=1e-6, maxiter=50)
    rel = float(torch.linalg.vector_norm(info.x - ref.x) / torch.linalg.vector_norm(ref.x))
    check(rel < 1e-3, f"column-limited CG disagrees with csr/plain CG: rel {rel}")
    results["tiled_cg"] = phase(
        f"cg {g}^3 column-limited", max_resident_cols=tpol.max_resident_cols,
        chosen=f"{tuned.format}/{tuned.policy.backends[0]}", iters=info.iters,
        rel_res=float(info.rel_res), rel_err=rel, launches=json.dumps(launches_tiled))
    del A_tiled, tuned, info, ref, b
    lap("5 tiled_cg")

    # ---------------------------------------------------------------- 6
    _, launches_tuner, _ = counted("tuner 10^6", lambda: phase_tuner(results))
    lap("6 tuner")

    # ---------------------------------------------------------------- 7
    _, launches_corpus, _ = counted("corpus", lambda: phase_corpus(results))
    check(launches_corpus["coo_spmv"] > 0, "coo_spmv was not launched on the corpus path")
    lap("7 corpus")

    # ---------------------------------------------------------------- 8
    _, launches_block, _ = counted("block", lambda: phase_block(results, block))
    del block
    lap("8 block")

    # ---------------------------------------------------------------- 9
    resp, launches_pred, _ = counted(f"hpcg {g}^3 predict", lambda: run_hpcg(
        g, g, g, iters=50, depth=4, tune_mode="predict", device="cuda"))
    check(resp.valid and resp.bitwise,
          f"HPCG {g}^3 predict: valid={resp.valid} bitwise={resp.bitwise}")
    results["hpcg_predict"] = phase(
        f"hpcg {g}^3 predict", valid=resp.valid, bitwise=resp.bitwise, rel_err=resp.rel_err,
        pcg_iters=resp.pcg_iters, rel_res=resp.rel_res, chosen=resp.chosen,
        levels=repr(resp.mg_levels), t_ref_s=resp.ref_time_s, t_opt_s=resp.opt_time_s,
        launches=json.dumps(launches_pred))
    lap("9 hpcg104 predict")

    by_path = {"hpcg": launches_hpcg, "tiled_cg": launches_tiled,
               "tuner": launches_tuner, "corpus": launches_corpus, "scoo": launches_scoo,
               "block": launches_block, "hpcg_predict": launches_pred}
    for name, path in REQUIRED_ON.items():
        check(by_path[path][name] > 0, f"{name} was not launched on the {path} path")

    line = {"kernels": []}
    for name, (src, replaces) in KERNEL_SOURCES.items():
        k = kern[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": by_path[REQUIRED_ON[name]][name],
            **{f"launches_{p}": counts[name] for p, counts in by_path.items()},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "kernel_ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library_kernel_ms": k["library_kernel_ms"],
            **{key: k[key] for key in EXTRA_KEYS if key in k}})
        if name == "dia_spmv":  # by level, masked or not, on the two HPCG paths
            line["kernels"][-1]["launches_split"] = {
                p: by_path[p]["dia_spmv_split"] for p in ("hpcg", "hpcg_predict")}
    results["seconds"] = seconds
    results["total_s"] = round(time.perf_counter() - t_start, 1)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"results": results, "kernels": line["kernels"]}, f, indent=1, default=str)
    print(f"[done] total_s={results['total_s']} seconds={json.dumps(seconds)}")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
