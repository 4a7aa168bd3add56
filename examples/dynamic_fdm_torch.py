"""Time-dependent FDM assembly through the port's dynamic-matrix lane, as
``examples/dynamic_fdm.py``.

  PYTHONPATH=src python examples/dynamic_fdm_torch.py
  PYTHONPATH=src python examples/dynamic_fdm_torch.py --grid 8 --steps 10
  PYTHONPATH=src python examples/dynamic_fdm_torch.py --threshold 0.1 --device cpu

A 27-point stencil operator (HPCG's ``fdm27``) is admitted into a
``ServeEngine`` once, then mutated in place across time steps via a
``DeltaOverlay`` (``engine.mutable``): coefficient jitter on the diagonal
plus widening long-range couplings past the stencil band. After each step
``engine.refresh`` compacts the delta and re-selects the (format, backend)
decision *only* when the accumulated structural drift crosses the engine's
threshold; below it the tuned policy is kept and no kernels run. The
trajectory printed per step shows drift growing until the threshold trips,
the re-tune firing once, and serving continuing warm off the refreshed
fingerprint. Runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np

from repro_torch.core.matrices import fdm27, perturb_fdm27
from repro_torch.serve.engine import ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=6,
                    help="stencil grid edge (matrix is n=grid^3)")
    ap.add_argument("--steps", type=int, default=8,
                    help="assembly time steps to simulate")
    ap.add_argument("--threshold", type=float, default=None,
                    help="drift threshold (default: DEFAULT_DRIFT_THRESHOLD)")
    ap.add_argument("--device", default="cuda", help="where the engine serves (default cuda)")
    args = ap.parse_args()

    nx = ny = nz = args.grid
    a = fdm27(nx, ny, nz)
    engine = ServeEngine(capacity=8, drift_threshold=args.threshold, device=args.device)
    overlay = engine.mutable(a)
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)

    print(f"fdm27 {nx}x{ny}x{nz}: n={a.shape[0]}, nnz={a.nnz}, "
          f"base key={overlay.format}, threshold={engine.drift_threshold}")
    for step in range(1, args.steps + 1):
        nmut = perturb_fdm27(overlay, step, nx, ny, nz)
        res = engine.refresh(overlay)
        # serve off the (possibly refreshed) fingerprint and check exactness
        t = engine.submit(res.fingerprint_after, x)
        engine.flush()
        ref = overlay.to_scipy() @ x
        ok = np.allclose(t.result().cpu().numpy(), ref, rtol=1e-4, atol=1e-5)
        print(f"  step {step:2d}: {nmut:3d} mutations, "
              f"drift={res.drift.score:6.3f}, "
              f"{'RETUNED -> ' + str(res.key_after) if res.retuned else 'kept'}"
              f"{'' if ok else '  [MISMATCH]'}")

    s = engine.stats.summary()
    print(f"refreshes={s['refreshes']} retunes={s['refresh_retunes']} "
          f"reselects={s['refresh_reselects']} "
          f"hit_rate={s['hit_rate']:.2f}")


if __name__ == "__main__":
    main()
