#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
     and the build of every kernel from ``src/repro_torch/csrc`` (nvcc runs at
     first use; ptxas register and spill lines are printed);
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     shapes of HPCG 104^3: ``scs_spmv`` on the finest level's tiled plan and on
     the resident plan of 52^3, ``dia_spmv`` on the finest level,
     ``dia_spmv_tiled`` on the finest level under ``max_resident_cols=1<<18``,
     and the masked DIA wrapper against ``where(mask, A @ x, 0)`` (exact).
     Each line gives the median kernel time (CUDA events), the plain
     version's time, a cuSPARSE CSR SpMV as a yardstick (never called by the
     port), and the byte bound at 3.35 TB/s;
  3. HPCG 16^3 on the card: ``valid`` and ``bitwise``;
  4. the main path, ``run_hpcg(104, 104, 104, iters=50, depth=4, reps=3)``
     over csr/sell/dia x plain/cuda, with the launch counters and the
     health registry reset just before it and read just after. It requires
     ``bitwise``, ``rel_err < 1e-3``, no failure or non-finite output on any
     ``*/cuda`` key, every cuda candidate timed, and ``scs_spmv`` and
     ``dia_spmv`` launched;
  5. the path that takes the tiled kernels, counted on its own the same
     way: a column-limited operator (``max_resident_cols=1<<18``) tuned over
     the cuda kernels and solved with CG, which must agree with csr/plain CG
     and launch ``dia_spmv_tiled``.

The line before last is a JSON object with each kernel's numbers
(``launches`` is the count on the path that requires the kernel; both
paths' counts are given as ``launches_hpcg`` and ``launches_tiled_cg``); the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero. It needs ``torch.cuda.is_available()`` and the
repository's ``src/`` beside it. Full numbers also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 outside the
#: tensor cores — the roofline of a CUDA-core f32 SpMV.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: HPCG's default local grid (the ``hpcg.dat`` of the reference distribution).
GRID = 104
#: The ``max_resident_cols`` that sends the 104^3 matrix to the tiled kernels.
COLUMN_LIMIT = 1 << 18

KERNEL_SOURCES = {
    "scs_spmv": ("src/repro_torch/csrc/sell_spmv.cu", "src/repro/kernels/sell_spmv.py:64"),
    "dia_spmv": ("src/repro_torch/csrc/dia_spmv.cu", "src/repro/kernels/dia_spmv.py:58"),
    "dia_spmv_tiled": ("src/repro_torch/csrc/dia_spmv.cu", "src/repro/kernels/dia_spmv.py:135"),
}


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved: int, flops: int):
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, y, y_plain, rtol=2e-4):
    """f32 tolerance of the conformance grid: rtol 2e-4 with an atol scaled
    to ||y||_inf (sums of ~27 products reassociated)."""
    import torch

    y, y_plain = y.float(), y_plain.float()
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    err = (y - y_plain).abs()
    atol = rtol * float(y_plain.abs().max())
    ok = bool((err <= atol + rtol * y_plain.abs()).all())
    check(ok, f"{name}: kernel disagrees with its plain version (max err {float(err.max())})")
    return float(err.max())


def phase_kernels(results: dict) -> dict:
    """Phase 2: every kernel against its plain version at the main path's
    shapes; returns the per-kernel numbers the JSON line reports."""
    import numpy as np
    import torch

    from repro_torch.core import ExecutionPolicy, matrices as M
    from repro_torch.core.convert import to_csr, to_dia
    from repro_torch.kernels import ops
    from repro_torch.kernels.dia_spmv import (dia_spmv, dia_spmv_plain, dia_spmv_tiled,
                                              dia_spmv_tiled_plain)
    from repro_torch.kernels.sell_spmv import (scs_spmv_from_plan, scs_spmv_plain,
                                               window_runs)

    dev = torch.device("cuda")
    out = {}

    def library_ms(s, x):
        A = torch.sparse_csr_tensor(torch.from_numpy(s.indptr.astype(np.int64)),
                                    torch.from_numpy(s.indices.astype(np.int64)),
                                    torch.from_numpy(s.data.astype(np.float32)),
                                    size=s.shape).to(dev)
        return cuda_ms(lambda: A @ x, reps=20)

    for g, label in ((GRID, "finest"), (GRID // 2, "coarse")):
        s = M.fdm27(g, g, g)
        n = s.shape[0]
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32)).to(dev)
        A = to_csr(s, device=dev)
        plan = A.plan
        btile, bwin, lsl, idx2, dat2, perm = plan.arrays
        ct, ntiles, C, sw, jb, nwin = plan.meta
        run_start = window_runs(bwin, nwin)
        y = scs_spmv_from_plan(plan, x, nrows=n)
        y_plain = scs_spmv_plain(*plan.arrays, x, nrows=n, col_tile=ct, ntiles=ntiles,
                                 C=C, sw=sw, jb=jb, nwin=nwin)
        err = compare(f"scs_spmv {g}^3", y, y_plain)
        y2 = scs_spmv_from_plan(plan, x, nrows=n)
        check(bool(torch.equal(y, y2)), f"scs_spmv {g}^3: two launches differ")
        moved = nbytes(btile, lsl, idx2, dat2, perm, run_start, x) + n * 4
        b_ms, b_by = bound(moved, 2 * s.nnz)
        rec = dict(
            grid=g, strategy=ops.cuda_strategy(A, ExecutionPolicy()), ntiles=ntiles,
            blocks=int(btile.shape[0]), index_dtype=str(idx2.dtype),
            max_abs_err=err, ms=cuda_ms(lambda: scs_spmv_from_plan(plan, x, nrows=n), 50),
            plain_ms=cuda_ms(lambda: scs_spmv_plain(*plan.arrays, x, nrows=n, col_tile=ct,
                                                    ntiles=ntiles, C=C, sw=sw, jb=jb,
                                                    nwin=nwin), 5),
            library_ms=library_ms(s, x), bytes=moved, bound_ms=b_ms, bound_by=b_by)
        results[f"scs_spmv_{label}"] = phase(f"kernel scs_spmv {label} {g}^3", **rec)
        if label == "finest":
            out["scs_spmv"] = rec

        if label != "finest":
            continue
        # resident DIA on the finest level
        D = to_dia(s, device=dev)
        y = dia_spmv(D.offsets, D.data, x)
        y_plain = dia_spmv_plain(D.offsets, D.data, x)
        err = compare(f"dia_spmv {g}^3", y, y_plain)
        moved = nbytes(D.offsets, D.data, x) + n * 4
        b_ms, b_by = bound(moved, 2 * s.nnz)
        rec = dict(grid=g, strategy=ops.cuda_strategy(D, ExecutionPolicy()),
                   exact=bool(torch.equal(y, y_plain)), max_abs_err=err,
                   ms=cuda_ms(lambda: dia_spmv(D.offsets, D.data, x), 50),
                   plain_ms=cuda_ms(lambda: dia_spmv_plain(D.offsets, D.data, x), 5),
                   library_ms=library_ms(s, x), bytes=moved, bound_ms=b_ms, bound_by=b_by)
        results["dia_spmv"] = phase(f"kernel dia_spmv {g}^3", **rec)
        out["dia_spmv"] = rec

        # the masked wrapper (one SymGS color) against where(mask, A @ x, 0)
        mask = torch.from_numpy((np.arange(n) % 8) == 3).to(dev)
        pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
        ym = ops.dia_masked_spmv_cuda(D, x, mask, pol)
        want = torch.where(mask, ops.dia_spmv_cuda(D, x, pol), torch.zeros((), device=dev))
        check(bool(torch.equal(ym, want)), "masked DIA != where(mask, A @ x, 0)")
        results["dia_masked"] = phase(
            f"kernel dia_masked {g}^3", exact=True,
            ms=cuda_ms(lambda: ops.dia_masked_spmv_cuda(D, x, mask, pol), 50))

        # tiled DIA on the finest level under a smaller column limit
        tpol = ExecutionPolicy(max_resident_cols=COLUMN_LIMIT)
        DT = to_dia(s, col_tile=tpol.col_tile(n), device=dev)
        check(ops.cuda_strategy(DT, tpol) == "tiled", "dia under the column limit is not tiled")
        offs_t, dat_w = DT.plan.arrays
        ct_d = DT.plan.ct
        rng = (int(offs_t.min()), int(offs_t.max()))
        y = dia_spmv_tiled(offs_t, dat_w, x, nrows=n, col_tile=ct_d, offset_range=rng)
        y_plain = dia_spmv_tiled_plain(offs_t, dat_w, x, nrows=n, col_tile=ct_d)
        err = compare(f"dia_spmv_tiled {g}^3", y, y_plain)
        moved = nbytes(offs_t, dat_w, x) + n * 4
        b_ms, b_by = bound(moved, 2 * s.nnz)
        rec = dict(grid=g, strategy="tiled", max_resident_cols=tpol.max_resident_cols, ct=ct_d, ntiles=DT.plan.ntiles,
                   max_d=int(offs_t.shape[1]), exact=bool(torch.equal(y, y_plain)),
                   max_abs_err=err,
                   ms=cuda_ms(lambda: dia_spmv_tiled(offs_t, dat_w, x, nrows=n,
                                                     col_tile=ct_d, offset_range=rng), 50),
                   plain_ms=cuda_ms(lambda: dia_spmv_tiled_plain(offs_t, dat_w, x, nrows=n,
                                                                 col_tile=ct_d), 3),
                   library_ms=library_ms(s, x), bytes=moved, bound_ms=b_ms, bound_by=b_by)
        results["dia_spmv_tiled"] = phase(f"kernel dia_spmv_tiled {g}^3", **rec)
        out["dia_spmv_tiled"] = rec
        del D, DT
    return out


def reset_counters() -> dict:
    """Every kernel wrapper by name, its launch counter set to 0."""
    from repro_torch.kernels.dia_spmv import dia_spmv, dia_spmv_tiled
    from repro_torch.kernels.sell_spmv import scs_spmv

    for fn in (scs_spmv, dia_spmv, dia_spmv_tiled):
        fn.launches = 0
    return {"scs_spmv": scs_spmv, "dia_spmv": dia_spmv, "dia_spmv_tiled": dia_spmv_tiled}


def counted(label: str, drive):
    """Run ``drive()`` with every launch counter and the health registry
    reset just before it; read both just after. Fails on any failure or
    non-finite output of a ``*/cuda`` key. Returns (drive's value, launches)."""
    from repro_torch.core import health_registry

    counters = reset_counters()
    health_registry().reset()
    value = drive()
    launches = {k: fn.launches for k, fn in counters.items()}
    faults = {k: v for k, v in health_registry().snapshot()["keys"].items()
              if k.endswith("/cuda") and (v["failures"] or v["nonfinite"])}
    phase(f"{label} counts", launches=json.dumps(launches), cuda_faults=json.dumps(faults))
    check(not faults, f"{label}: cuda keys failed or went non-finite: {faults}")
    return value, launches


CANDIDATES = [("csr", "plain"), ("csr", "cuda"), ("sell", "plain"),
              ("sell", "cuda"), ("dia", "plain"), ("dia", "cuda")]

#: The path on which each kernel must launch: the HPCG run (phase 4) or the
#: column-limited CG (phase 5).
REQUIRED_ON = {"scs_spmv": "hpcg", "dia_spmv": "hpcg", "dia_spmv_tiled": "tiled_cg"}


def check_hpcg(res, label: str) -> None:
    check(res.bitwise, f"{label}: bitwise tier failed")
    check(res.rel_err < 1e-3, f"{label}: rel_err {res.rel_err} >= 1e-3")
    for fmt, impl in CANDIDATES:
        if impl == "cuda":
            check(f"{fmt}/{impl}" in res.table, f"{label}: {fmt}/cuda missing from the tune table")
    errs = [sk for sk in res.skipped if sk[2].startswith("error:")]
    check(not errs, f"{label}: candidates raised: {errs}")


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

    # ---------------------------------------------------------------- 2
    kern = phase_kernels(results)

    # ---------------------------------------------------------------- 3
    r16 = run_hpcg(16, 16, 16, iters=50, timed=False, candidates=CANDIDATES, device="cuda")
    check(r16.valid and r16.bitwise, f"HPCG 16^3: valid={r16.valid} bitwise={r16.bitwise}")
    results["hpcg16"] = phase("hpcg 16^3", valid=r16.valid, bitwise=r16.bitwise,
                              pcg_iters=r16.pcg_iters, rel_res=r16.rel_res,
                              levels=repr(r16.mg_levels))

    # ---------------------------------------------------------------- 4
    g = GRID
    t0 = time.perf_counter()
    res, launches_hpcg = counted(f"hpcg {g}^3", lambda: run_hpcg(
        g, g, g, iters=50, depth=4, reps=3, candidates=CANDIDATES, device="cuda"))
    t_hpcg = time.perf_counter() - t0
    check_hpcg(res, f"HPCG {g}^3")
    results["hpcg"] = phase(
        f"hpcg {g}^3", valid=res.valid, bitwise=res.bitwise, rel_err=res.rel_err,
        pcg_iters=res.pcg_iters, rel_res=res.rel_res,
        converged=res.rel_res <= 1e-6, chosen=res.chosen, levels=repr(res.mg_levels),
        t_ref_s=res.ref_time_s, t_opt_s=res.opt_time_s, wall_s=round(t_hpcg, 1),
        launches=json.dumps(launches_hpcg), table=json.dumps(res.table))

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

    (tuned, info), launches_tiled = counted(f"cg {g}^3 column-limited", tiled_cg)
    ref = cg(as_operator(A_sp, "csr", device="cuda").using("plain"), b, tol=1e-6, maxiter=50)
    rel = float(torch.linalg.vector_norm(info.x - ref.x) / torch.linalg.vector_norm(ref.x))
    check(rel < 1e-3, f"column-limited CG disagrees with csr/plain CG: rel {rel}")
    results["tiled_cg"] = phase(
        f"cg {g}^3 column-limited", max_resident_cols=tpol.max_resident_cols,
        chosen=f"{tuned.format}/{tuned.policy.backends[0]}", iters=info.iters,
        rel_res=float(info.rel_res), rel_err=rel, launches=json.dumps(launches_tiled))

    by_path = {"hpcg": launches_hpcg, "tiled_cg": launches_tiled}
    for name, path in REQUIRED_ON.items():
        check(by_path[path][name] > 0, f"{name} was not launched on the {path} path")

    line = {"kernels": []}
    for name, (src, replaces) in KERNEL_SOURCES.items():
        k = kern[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": by_path[REQUIRED_ON[name]][name],
            "launches_hpcg": launches_hpcg[name], "launches_tiled_cg": launches_tiled[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    results["total_s"] = round(time.perf_counter() - t_start, 1)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"results": results, "kernels": line["kernels"]}, f, indent=1, default=str)
    print(f"[done] total_s={results['total_s']}")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
