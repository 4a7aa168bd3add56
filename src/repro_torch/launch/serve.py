"""Serving launcher: drive the multi-tenant engine with seeded traffic and
print the stats the serving path tracks, as ``repro.launch.serve``'s
sparse mode:

  python -m repro_torch.launch.serve --traffic hot --n 1048576 --requests 512 \
      --capacity 8 --max-batch 32 --flush-every 64
  python -m repro_torch.launch.serve --traffic churn --n 512 --device cpu \
      --capacity 4 --max-batch 16 --flush-every 32

Runs on the card unless ``--device cpu``. The reference's LM loop
(``serve_lm``) needs the models, which are not ported.
"""
from __future__ import annotations

import argparse

from repro_torch.serve import ServeEngine, TrafficSpec, run_traffic


def serve_traffic(args) -> dict:
    """The sparse request path: engine + seeded traffic mix -> summary."""
    engine = ServeEngine(capacity=args.capacity, max_batch=args.max_batch,
                         tune_mode=args.tune_mode, device=args.device)
    spec = TrafficSpec(mix=args.traffic, n=args.n,
                       n_matrices=args.tenants, seed=args.seed)
    out = run_traffic(engine, spec, args.requests,
                      flush_every=args.flush_every)
    print(f"mix={out['mix']} n={out['n']} tenants={out['n_matrices']} "
          f"requests={out['requests']} batches={out['batches']} device={args.device}")
    print(f"latency p50={out['latency_p50_s']*1e3:.2f}ms "
          f"p99={out['latency_p99_s']*1e3:.2f}ms  "
          f"throughput={out['throughput_rps']:.1f} req/s")
    print(f"warm pool: hit rate {out['hit_rate']:.0%} "
          f"(hits={out['cache_hits']} misses={out['cache_misses']} "
          f"evictions={out['workspace']['evictions']}), "
          f"tunes={out['tunes']}, fallbacks={out['dispatch_fallbacks']}")
    print(f"batching: mean={out['batch_size_mean']:.1f} "
          f"max={out['batch_size_max']} "
          f"coalesced={out['coalesced_fraction']:.0%} of requests")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--traffic", default="hot", choices=["hot", "churn", "mixed"],
                    help="the seeded traffic mix to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--n", type=int, default=96, help="tenant matrix dimension")
    ap.add_argument("--tenants", type=int, default=8,
                    help="distinct matrices in the churn/mixed pools")
    ap.add_argument("--capacity", type=int, default=4,
                    help="warm-pool size (operators held tuned)")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="widest SpMM tile one flush may form")
    ap.add_argument("--flush-every", type=int, default=16,
                    help="requests per batching window (0 = one window)")
    ap.add_argument("--tune-mode", default="predict",
                    choices=["predict", "run", "none"],
                    help="admission tuning for first-sight matrices")
    ap.add_argument("--device", default="cuda",
                    help="where tenants and right-hand sides live (default cuda)")
    args = ap.parse_args(argv)
    if args.tune_mode == "none":
        args.tune_mode = None
    serve_traffic(args)


if __name__ == "__main__":
    main()
