"""Serving example of the PyTorch port: an MoE model with runtime-switchable
sparse dispatch inside an LM serving loop, as ``examples/serve_moe_sparse.py``.

  PYTHONPATH=src python examples/serve_moe_sparse_torch.py --impl bsr --spmv-backend cuda
  PYTHONPATH=src python examples/serve_moe_sparse_torch.py --tune
  PYTHONPATH=src python examples/serve_moe_sparse_torch.py --impl coo --device cpu

The model is ``qwen3-moe-235b-a22b``'s smoke config. The ``coo`` and
``bsr`` lanes route expert dispatch and combine through ``SparseOperator``,
so ``--spmv-backend`` (``cuda``: the hand-written kernels; ``plain``,
``dense``) scopes the policy that picks their kernels. Decode-step
latencies go through ``repro_torch.serve.stats``. Runs on the card unless
``--device cpu``.
"""
import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import resolve_device, use_backend
from repro_torch.models import build_model
from repro_torch.serve.stats import BatchRecord, RequestRecord, ServeStats


def build(impl: str, device):
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=impl))
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return cfg, model, params


def serve(cfg, model, params, B=8, S=32, G=16):
    """Prefill + generate; returns (tok/s, ServeStats over decode steps)."""
    dev = model.device
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    caches = model.init_caches(B, S + G)
    for t in range(S):                       # prefill via decode
        logits, caches = model.decode_step(params, tokens[:, t:t + 1], caches, t)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    tok.cpu()
    stats = ServeStats()
    t0 = time.perf_counter()
    for g in range(G):
        t_step = time.perf_counter()
        logits, caches = model.decode_step(params, tok, caches, S + g)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tok.cpu()  # the step ends when its token is on the host
        dt = time.perf_counter() - t_step
        rec = RequestRecord(rid=g, fingerprint=cfg.name, batch_size=B,
                            cache_hit=g > 0, coalesced=B > 1,
                            queue_wait_s=0.0, latency_s=dt)
        stats.record_batch(BatchRecord(fingerprint=cfg.name, size=B,
                                       coalesced=B > 1, cache_hit=g > 0,
                                       exec_s=dt), [rec])
    dt = time.perf_counter() - t0
    return B * G / dt, stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="sort", choices=["sort", "onehot", "coo", "bsr"])
    ap.add_argument("--tune", action="store_true",
                    help="run-first auto-tune the dispatch impl, then serve")
    ap.add_argument("--spmv-backend", default=None, choices=["plain", "dense", "cuda"],
                    help="ExecutionPolicy backend for the sparse dispatch SpMM")
    ap.add_argument("--device", default="cuda", help="where the model runs (default cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    policy_scope = (use_backend(args.spmv_backend) if args.spmv_backend
                    else contextlib.nullcontext())
    with policy_scope:
        if args.tune:
            best, best_tps = None, 0.0
            for impl in ["sort", "onehot", "coo", "bsr"]:
                cfg, model, params = build(impl, dev)
                tps, _ = serve(cfg, model, params, G=8)
                print(f"  dispatch={impl:7s}: {tps:.1f} tok/s")
                if tps > best_tps:
                    best, best_tps = impl, tps
            print(f"auto-tuner picks: {best}")
            impl = best
        else:
            impl = args.impl
        cfg, model, params = build(impl, dev)
        tps, stats = serve(cfg, model, params)
    print(f"serving qwen3-moe(smoke) with dispatch={impl} on {dev}: {tps:.1f} tok/s "
          f"(step p50={stats.latency_percentile(50)*1e3:.1f} "
          f"p99={stats.latency_percentile(99)*1e3:.1f} ms)")


if __name__ == "__main__":
    main()
