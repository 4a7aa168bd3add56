"""Where the time of a tuned HPCG solve goes on the PyTorch/CUDA port.

  python examples/hpcg_torch.py                        # HPCG 104^3, 5 PCG iterations, eager and captured
  python examples/hpcg_torch.py --grid 32 --iters 10
  python examples/hpcg_torch.py --parts 4              # distributed over four parts of the card

Builds the tuned pipeline (run-first tuner on the operator and every
multigrid level, candidates csr/sell/dia x plain/cuda), times N fixed PCG
iterations without the profiler and counts the SpMV kernel launches they
make, then traces the same N iterations with ``torch.profiler`` and prints
the device time by kernel and the share of the wall time the device was
busy (sum of device-side kernel times over the traced wall time; kernels
run on one stream and do not overlap). Then it captures the same solve in
one CUDA graph (``CapturedSolve``, as ``run_hpcg`` times it), prints the
capture and instantiation seconds and the graph's nodes, checks that a
replay gives the eager bits, and times and traces one replay the same way. With ``--parts N`` the pipeline is
``run_hpcg_distributed``'s: the operator tuned per part
(``tune_partitions``) and the V-cycle distributed and tuned per part and
level (``distribute_vcycle``) over csr/dia/ell/coo x plain/cuda, on
``PartMesh.on("cuda", parts=N)``, depth clamped by
``distributable_depth``. ``--depth`` caps the levels. Needs a CUDA device.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import PartMesh, autotune_spmv  # noqa: E402
from repro_torch.core import matrices as M  # noqa: E402
from repro_torch.distributed_op import tune_partitions  # noqa: E402
from repro_torch.kernels.coo_spmv import coo_spmv  # noqa: E402
from repro_torch.kernels.dia_spmv import dia_spmv, dia_spmv_tiled  # noqa: E402
from repro_torch.kernels.ell_spmv import ell_spmv  # noqa: E402
from repro_torch.kernels.sell_spmv import scs_spmv  # noqa: E402
from repro_torch.solvers import (  # noqa: E402
    CapturedSolve, build_mg, distributable_depth, distribute_vcycle, pcg_solve)

CANDIDATES = [("csr", "plain"), ("csr", "cuda"), ("sell", "plain"),
              ("sell", "cuda"), ("dia", "plain"), ("dia", "cuda")]
#: The distributed path's candidates: the formats a part's container takes.
DIST_CANDIDATES = [(f, b) for f in ("csr", "dia", "ell", "coo") for b in ("plain", "cuda")]
KERNELS = {"dia_spmv": dia_spmv, "dia_spmv_tiled": dia_spmv_tiled, "scs_spmv": scs_spmv,
           "ell_spmv": ell_spmv, "coo_spmv": coo_spmv}


def tuned_pipeline(A_sp, g: int, depth: int, parts: int, dev):
    """(operator, V-cycle, describe) tuned as ``run_hpcg`` tunes them, or
    with ``parts > 1`` as ``run_hpcg_distributed`` does."""
    if parts == 1:
        A = autotune_spmv(A_sp, candidates=CANDIDATES, device=dev).operator
        mg = build_mg(g, g, g, depth=depth, device=dev).retuned(CANDIDATES)
        return A, mg, mg.describe()
    mesh = PartMesh.on(dev, parts)
    depth = distributable_depth(g, g, g, parts, depth=depth)
    A, _ = tune_partitions(A_sp, mesh, candidates=DIST_CANDIDATES)
    mg = distribute_vcycle(build_mg(g, g, g, depth=depth, device=dev), mesh, tune=True,
                           candidates=DIST_CANDIDATES)
    levels = " | ".join(f"{'x'.join(map(str, l.grid))}: {l.A.describe()}" for l in mg.levels)
    return A, mg, f"operator {A.describe()}; {levels}"


def profile_pcg(g: int, iters: int, depth: int, parts: int) -> None:
    dev = torch.device("cuda")
    A_sp = M.fdm27(g, g, g)
    b = torch.from_numpy((A_sp @ np.ones(A_sp.shape[0])).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    A, mg, described = tuned_pipeline(A_sp, g, depth, parts, dev)
    print(f"setup {time.perf_counter() - t0:.1f}s  parts={parts} depth={mg.depth}  "
          f"levels: {described}")
    calls = {"operator": 0, "vcycle": 0}

    def op(p):
        calls["operator"] += 1
        return A @ p

    def precond(r):
        calls["vcycle"] += 1
        return mg(r)

    def solve(rhs=b):
        return pcg_solve(op, rhs, iters, precond=precond)

    x_eager, _ = solve()
    torch.cuda.synchronize(dev)
    for fn in KERNELS.values():
        fn.launches = 0
    calls.update(operator=0, vcycle=0)
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    print(f"{iters} PCG iterations: {wall * 1e3:.3f} ms unprofiled; operator SpMVs "
          f"{calls['operator']}, V-cycles {calls['vcycle']}, kernel launches {launches}")
    trace("eager", solve, dev)

    captured = CapturedSolve(solve, b)
    st = captured.stats()
    x_graph, _ = captured(b)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    captured(b)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    print(f"graph: capture {st['capture_s']:.3f} s, instantiate {st['instantiate_s']:.3f} s, "
          f"{st['nodes']} nodes, kernel launches {st['launches']}; replay "
          f"{wall * 1e3:.3f} ms unprofiled, eager bits {torch.equal(x_graph, x_eager)}")
    trace("replay", lambda: captured(b), dev)


def trace(label: str, run, dev) -> None:
    """Trace one ``run()`` with ``torch.profiler``: the device-busy share of
    the traced wall and the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        traced = time.perf_counter() - t0
    # device-side entries only: an aten op's own entry repeats the device
    # time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in events) / 1e6
    print(f"{label}: traced wall {traced * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
          f"({100 * busy / traced:.1f}% of the traced wall)")
    top = sorted(events, key=dev_us, reverse=True)[:12]
    for e in top:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:7d} calls  {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=104, help="HPCG grid edge")
    ap.add_argument("--iters", type=int, default=5, help="PCG iterations to time and trace")
    ap.add_argument("--depth", type=int, default=4, help="multigrid levels at most")
    ap.add_argument("--parts", type=int, default=1,
                    help="parts of the distributed pipeline on the card (1: serial)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    profile_pcg(args.grid, args.iters, args.depth, args.parts)


if __name__ == "__main__":
    main()
