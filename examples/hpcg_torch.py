"""Where the time of a tuned HPCG solve goes on the PyTorch/CUDA port.

  python examples/hpcg_torch.py                        # HPCG 104^3, 5 traced PCG iterations
  python examples/hpcg_torch.py --grid 32 --iters 10

Builds the tuned pipeline (run-first tuner on the operator and every
multigrid level, candidates csr/sell/dia x plain/cuda), times N fixed PCG
iterations without the profiler and counts the SpMV kernel launches they
make, then traces the same N iterations with ``torch.profiler`` and prints
the device time by kernel and the share of the wall time the device was
busy (sum of device-side kernel times over the traced wall time; kernels
run on one stream and do not overlap). Needs a CUDA device.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import autotune_spmv  # noqa: E402
from repro_torch.core import matrices as M  # noqa: E402
from repro_torch.kernels.dia_spmv import dia_spmv, dia_spmv_tiled  # noqa: E402
from repro_torch.kernels.sell_spmv import scs_spmv  # noqa: E402
from repro_torch.solvers import build_mg, pcg_solve  # noqa: E402

CANDIDATES = [("csr", "plain"), ("csr", "cuda"), ("sell", "plain"),
              ("sell", "cuda"), ("dia", "plain"), ("dia", "cuda")]
KERNELS = {"dia_spmv": dia_spmv, "dia_spmv_tiled": dia_spmv_tiled, "scs_spmv": scs_spmv}


def profile_pcg(g: int, iters: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    A_sp = M.fdm27(g, g, g)
    b = torch.from_numpy((A_sp @ np.ones(A_sp.shape[0])).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    A = autotune_spmv(A_sp, candidates=CANDIDATES, device=dev).operator
    mg = build_mg(g, g, g, depth=4, device=dev).retuned(CANDIDATES)
    print(f"setup {time.perf_counter() - t0:.1f}s  levels: {mg.describe()}")
    calls = {"operator": 0, "vcycle": 0}

    def op(p):
        calls["operator"] += 1
        return A @ p

    def precond(r):
        calls["vcycle"] += 1
        return mg(r)

    def solve():
        return pcg_solve(op, b, iters, precond=precond)

    solve()
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize(dev)
        traced = time.perf_counter() - t0
    # device-side entries only: an aten op's own entry repeats the device
    # time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in events) / 1e6
    print(f"traced wall {traced * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
          f"({100 * busy / traced:.1f}% of the traced wall)")
    top = sorted(events, key=dev_us, reverse=True)[:12]
    for e in top:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  {e.count:7d} calls  {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=104, help="HPCG grid edge")
    ap.add_argument("--iters", type=int, default=5, help="PCG iterations to time and trace")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    profile_pcg(args.grid, args.iters)


if __name__ == "__main__":
    main()
