"""Time the tolerance CG as CUDA graphs (``repro_torch.solvers.CapturedCG``)
over chunk sizes, beside the eager ``cg``, on HPCG's stencil.

    python examples/cg_chunk_sweep.py [--grids 104,16] [--chunks 1,2,3,4,6,8,16,50]

For each grid: the 27-point stencil as dia/cuda under its V-cycle (every
level dia/cuda, depth 4, as ``run_hpcg`` builds it), HPCG's
right-hand side, tol 1e-6, 50 iterations at most. The eager ``cg`` is timed
(median of 3, each ended by a synchronize), then for each chunk a
``CapturedCG`` is built (capture and instantiation seconds, nodes of the
chunk's graph) and called 3 times (median), and each call's ``x`` and
iterations are held to the eager solve's bits. A line a chunk: iterations
taken and computed, replays, host reads, median seconds. Needs a card.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import as_operator
from repro_torch.core import matrices as M
from repro_torch.solvers import CapturedCG, build_mg, cg


def timed(fn, reps=3):
    ts, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grids", default="104,16")
    ap.add_argument("--chunks", default="1,2,3,4,6,8,16,50")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cg_chunk_sweep: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    for g in (int(v) for v in args.grids.split(",")):
        s = M.fdm27(g, g, g)
        b = torch.from_numpy((s @ np.ones(s.shape[0])).astype(np.float32)).cuda()
        depth = 4
        A = as_operator(s, "dia", device="cuda").using("cuda")
        mg = build_mg(g, g, g, depth=depth, device="cuda").retuned([("dia", "cuda")])
        cg(A, b, tol=1e-6, maxiter=50, precond=mg)  # first-call caches
        eager_s, want = timed(lambda: cg(A, b, tol=1e-6, maxiter=50, precond=mg))
        print(json.dumps({"grid": g, "depth": depth, "eager_s": eager_s, "iters": want.iters}),
              flush=True)
        for chunk in (int(v) for v in args.chunks.split(",")):
            solver = CapturedCG(A, b, tol=1e-6, maxiter=50, precond=mg, chunk=chunk)
            secs, got = timed(lambda: solver(b))
            st = solver.stats()
            print(json.dumps({
                "grid": g, "chunk": chunk, "seconds": secs, "eager_s": eager_s,
                "iters": st["iters"], "computed": st["computed"], "replays": st["replays"],
                "host_reads": st["replays"] + 1, "capture_s": round(st["capture_s"], 4),
                "instantiate_s": round(st["instantiate_s"], 4), "nodes": st["nodes"],
                "equal": bool(torch.equal(got.x, want.x) and got.iters == want.iters)}),
                flush=True)
            del solver, got


if __name__ == "__main__":
    main()
