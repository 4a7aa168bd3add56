"""Where a serving admission's time goes on the PyTorch/CUDA port.

  python examples/serve_admission.py                 # tenants of 2^20 rows, on the GPU
  python examples/serve_admission.py --n 4096 --device cpu

For one tenant of each archetype of the churn pool
(``repro_torch.serve.matrix_pool``: banded, random, power law, tridiag),
each stage of an admission is timed on a matrix no earlier stage touched
(the pool is made anew for each), every stage ended by a synchronize:

  - ``generate_s``: ``matrix_pool`` itself (traffic set-up, not admission);
  - ``fingerprint_s``: ``SpmvWorkspace.fingerprint``;
  - ``csr_host_s`` / ``csr_card_s``: ``as_operator(s, "csr")`` on the host
    and on ``--device`` (the difference is the copy);
  - ``predict_s``: the features and ``select.predict``;
  - ``tune_s``: ``tune(mode="predict")`` (the prediction again, then the
    conversion to the predicted format);
  - ``first_spmv_s`` / ``next_spmv_s``: the tuned operator's first SpMV
    (a kernel's adapter checks its container or plan on its first call on
    the card) and the median of the next five;
  - ``engine_s``: a fresh ``ServeEngine(capacity=8, max_batch=32,
    tune_mode="predict")`` submitting four requests and flushing: one
    admission and its first tile, as the churn mix pays them.

With ``--profile`` the engine's flush runs under ``cProfile`` and the 12
functions of largest cumulative time are printed for each tenant. Prints
the card's name and power limit first.
"""
import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import as_operator, select  # noqa: E402
from repro_torch.core.registry import SpmvWorkspace  # noqa: E402
from repro_torch.serve import ServeEngine, matrix_pool  # noqa: E402


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def tenant(n: int, i: int):
    """Tenant ``i`` of a fresh 4-tenant churn pool, and the pool's seconds."""
    pool, s = timed(lambda: matrix_pool(n, 4, seed=0), torch.device("cpu"))
    return pool[i], s


def stages(n: int, i: int, device: torch.device, profile: bool) -> dict:
    (name, s), gen_s = tenant(n, i)
    _, fp_s = timed(lambda: SpmvWorkspace.fingerprint(s), device)
    _, host_s = timed(lambda: as_operator(s, "csr", device="cpu"), device)
    (_, s), _ = tenant(n, i)
    op, card_s = timed(lambda: as_operator(s, "csr", device=device), device)
    _, predict_s = timed(lambda: select.predict(op.container, platform=device.type), device)
    tuned, tune_s = timed(lambda: op.tune(mode="predict"), device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32)).to(device)
    _, first_s = timed(lambda: tuned @ x, device)
    nexts = sorted(timed(lambda: tuned @ x, device)[1] for _ in range(5))

    (_, s), _ = tenant(n, i)
    eng = ServeEngine(capacity=8, max_batch=32, tune_mode="predict", device=device)
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    tickets = [eng.submit(s, rng.standard_normal(n).astype(np.float32)) for _ in range(4)]
    prof = cProfile.Profile() if profile else None
    if prof is not None:
        prof.enable()
    eng.flush()
    sync(device)
    if prof is not None:
        prof.disable()
    engine_s = time.perf_counter() - t0
    assert all(t.ok for t in tickets), [t.error for t in tickets]
    out = dict(tenant=name, key=f"{tuned.format}/{tuned.policy.backends[0]}",
               generate_s=gen_s, fingerprint_s=fp_s, csr_host_s=host_s, csr_card_s=card_s,
               predict_s=predict_s, tune_s=tune_s, first_spmv_s=first_s,
               next_spmv_s=nexts[len(nexts) // 2], engine_s=engine_s)
    print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in out.items()), flush=True)
    if prof is not None:
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).strip_dirs().sort_stats("cumulative").print_stats(12)
        print("\n".join(ln for ln in buf.getvalue().splitlines() if ln.strip())[-2000:])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        # build the kernels first, so that no stage pays for nvcc
        from repro_torch.kernels._build import library
        library()
    for i in range(4):
        stages(args.n, i, device, args.profile)


if __name__ == "__main__":
    main()
