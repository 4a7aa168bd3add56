"""Quickstart of the PyTorch port: the operator API, as ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. build matrices with different sparsity patterns
2. wrap them in SparseOperator and switch formats at runtime (cached)
3. run the same ``A @ x`` through the plain / dense / cuda backends via
   ExecutionPolicy (``cuda``: the hand-written kernels; on host tensors
   their plain versions)
4. let the run-first auto-tuner return a retargeted operator per matrix
5. the workspace's cached conversions

Runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import as_operator, resolve_device, use_backend, workspace
from repro_torch.core import matrices as M


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where the operators live (default cuda)")
    dev = resolve_device(ap.parse_args().device)
    rng = np.random.default_rng(0)

    print("== 1. three sparsity patterns ==")
    mats = {
        "banded (FDM-like)": M.banded(1024, 4, seed=0),
        "unstructured": M.random_uniform(1024, 0.02, seed=1),
        "power-law rows": M.powerlaw(1024, 8, seed=2),
    }
    for name, s in mats.items():
        print(f"  {name}: shape={s.shape} nnz={s.nnz}")

    print("\n== 2. runtime format switching (cached conversions) ==")
    A = as_operator(mats["banded (FDM-like)"], "csr", device=dev)
    for fmt in ["coo", "dia", "ell", "sell", "bsr"]:
        B = A.asformat(fmt)
        print(f"  csr -> {fmt}: container={type(B.container).__name__} "
              f"nnz(stored)={B.nnz} nbytes={B.nbytes}")

    print("\n== 3. same math, three backends ==")
    x = torch.from_numpy(rng.standard_normal(1024).astype(np.float32)).to(dev)
    A_dia = A.asformat("dia")
    for backend in ["plain", "dense", "cuda"]:
        with use_backend(backend):
            y = A_dia @ x
        print(f"  dia/{backend:7s} -> |y|={float(torch.linalg.vector_norm(y)):.4f}")

    print("\n== 4. run-first auto-tuner (paper §VII-D) ==")
    for name, s in mats.items():
        op = as_operator(s, device=dev).tune(iters=5, warmup=2)
        print(f"  {name:20s} -> {op.format}/{op.policy.backends[0]} "
              f"({op.nbytes} device bytes)")

    print("\n== 5. workspace (ArmPL handle analogue, true LRU) ==")
    ws = workspace()
    s = mats["power-law rows"]
    for _ in range(3):
        ws.spmv(s, x, "sell", device=dev)
    print(f"  3 calls -> conversions: {ws.misses}, cache hits: {ws.hits}, "
          f"entries: {len(ws)}")


if __name__ == "__main__":
    main()
