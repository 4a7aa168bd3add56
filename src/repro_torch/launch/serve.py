"""Serving launcher: the sparse request path (``ServeEngine`` traffic mixes)
and the batched LM prefill + decode loop, as ``repro.launch.serve``.

Sparse serving, selected by ``--traffic``:

  python -m repro_torch.launch.serve --traffic hot --n 1048576 --requests 512 \
      --capacity 8 --max-batch 32 --flush-every 64
  python -m repro_torch.launch.serve --traffic churn --n 512 --device cpu \
      --capacity 4 --max-batch 16 --flush-every 32

LM serving (the reference's flags, plus the port's):

  python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \
      --batch 4 --prompt-len 32 --gen 32 --device cpu --no-graph
  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --layers 4 \
      --dispatch-impl bsr
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke --device cpu --no-graph

``--layers`` cuts the model's depth (Jamba's in whole periods) and ``--dispatch-impl`` picks the MoE
lane; the sparse products run under ``use_backend("cuda")`` (the
hand-written kernels on the card, their plain versions on host tensors).
Runs on the card unless ``--device cpu``. ``--graph`` (the default) serves
the prompt and every generated token through one captured decode step
(``repro_torch.serve.CapturedDecode``), as the reference serves them
through one jitted, donated step; it needs the card, so the host takes
``--no-graph``, the eager step. With ``--traffic`` the engine serves
healthy tiles through its captured lanes on the card
(``repro_torch.serve.CapturedLane``, the reference's jitted ``_mv`` and
``_mm``) and eagerly on the host; ``--no-graph`` makes the card eager too,
and a line before the summary prints the lanes' counters. The LM loop
reports through ``repro_torch.serve.stats``: one request per generated
token batch, so its p50/p99 ms/token come from the same percentiles as
the sparse engine's latencies.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import resolve_device, use_backend
from repro_torch.models import build_model
from repro_torch.serve import CapturedDecode, ServeEngine, TrafficSpec, run_traffic
from repro_torch.serve.stats import BatchRecord, RequestRecord, ServeStats


def serve_traffic(args) -> dict:
    """The sparse request path: engine + seeded traffic mix -> summary."""
    engine = ServeEngine(capacity=args.capacity, max_batch=args.max_batch,
                         tune_mode=args.tune_mode, device=args.device,
                         graph=getattr(args, "graph", None))
    spec = TrafficSpec(mix=args.traffic, n=args.n,
                       n_matrices=args.tenants, seed=args.seed)
    out = run_traffic(engine, spec, args.requests,
                      flush_every=args.flush_every)
    g = engine.graph_stats()
    print(f"graph lanes: {'on' if engine.graph else 'off'} captures={g['captures']} "
          f"replays={g['replays']} capture={g['capture_s']:.3f}s "
          f"instantiate={g['instantiate_s']:.3f}s nodes={g['nodes']} live={g['live']}")
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
    return dict(out, graph=g)


def lm_config(args):
    """The served model's config: the arch's (or its smoke config), cut to
    ``--layers`` and given ``--dispatch-impl`` where those are set."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        if cfg.attn_period and args.layers % cfg.attn_period:
            raise ValueError(f"--layers {args.layers}: {cfg.name} is cut in whole periods of "
                             f"{cfg.attn_period} layers")
        cfg = cfg.replace(n_layers=args.layers)
    if args.dispatch_impl and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=args.dispatch_impl))
    return cfg


def serve_lm(args, params=None, logits_out: Optional[List[torch.Tensor]] = None) -> dict:
    """The LM loop: the prompt through the decode step, then greedy
    generation. ``params`` are the weights to serve (default: drawn on the
    device from a generator seeded with ``--seed``, every weight but the
    router kept in the activation dtype, the values the reference's
    per-use casts give). Each step's logits are appended to ``logits_out``
    where a list is given. With ``args.graph`` (default on) every step is a
    replay of one :class:`CapturedDecode`, captured before the prompt;
    without it the eager step. Returns the tokens (prompt and generated),
    the timings, the graph's stats (``None`` without one), the model and
    its params."""
    cfg = lm_config(args)
    dev = resolve_device(args.device)
    graph = getattr(args, "graph", True) is not False
    if graph and dev.type != "cuda":
        raise ValueError(f"graph=True serves through a decode step captured in a CUDA graph "
                         f"and needs a CUDA device, got {dev}; pass --no-graph (graph=False) "
                         f"to serve with the eager step")
    model = build_model(cfg, dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                            weight_dtype=cfg.activation_dtype)
    rng = np.random.default_rng(args.seed)  # the reference's prompt, drawn on the host
    B, S, G = args.batch, args.prompt_len, args.gen
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    if cfg.frontend in ("vision", "audio"):
        # the reference draws the stub's patches or frames and feeds them to
        # no step: the patch positions and the cross caches stay zero
        rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
    prefix = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    smax = prefix + S + G
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    with use_backend("cuda"):
        caches = model.init_caches(B, smax)
        if graph:
            step = captured = CapturedDecode(model, params, caches, B)
        else:
            captured = None

            def step(tok, pos):
                return model.decode_step(params, tok, caches, pos)[0]
        t0 = time.perf_counter()
        logits = None
        for t in range(S):
            logits = step(tokens[:, t:t + 1], prefix + t)
            if logits_out is not None:
                logits_out.append(logits)
        sync()
        t_prefill = time.perf_counter() - t0

        # each generated token batch is one serving request
        stats = ServeStats()
        fed, out = [], []
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        for g in range(G):
            t_step = time.perf_counter()
            fed.append(tok[:, 0])
            logits = step(tok, prefix + S + g)
            if logits_out is not None:
                logits_out.append(logits)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            out.append(tok[:, 0].cpu())  # the step ends when its token is on the host
            dt = time.perf_counter() - t_step
            rec = RequestRecord(rid=g, fingerprint=cfg.name, batch_size=B,
                                cache_hit=g > 0, coalesced=B > 1,
                                queue_wait_s=0.0, latency_s=dt)
            stats.record_batch(BatchRecord(fingerprint=cfg.name, size=B,
                                           coalesced=B > 1, cache_hit=g > 0,
                                           exec_s=dt), [rec])
        t_gen = time.perf_counter() - t0
    generated = torch.stack(out, dim=1)  # (B, G): each step's greedy token

    toks_s = B * G / t_gen
    p50, p99 = stats.latency_percentile(50), stats.latency_percentile(99)
    print(f"arch={cfg.name} layers={cfg.n_layers} B={B} prompt={S} gen={G} device={dev}")
    print(f"prompt phase: {t_prefill*1e3:.0f}ms; decode: {t_gen*1e3:.0f}ms "
          f"({toks_s:.1f} tok/s, {1e3*t_gen/G:.1f} ms/token, "
          f"p50={p50*1e3:.1f} p99={p99*1e3:.1f} ms/step)")
    if captured is not None:
        st = captured.stats()
        print(f"decode graph: capture={st['capture_s']:.3f}s "
              f"instantiate={st['instantiate_s']:.3f}s nodes={st['nodes']} "
              f"launches a step={st['launches']}")
    print("sample continuation (batch 0):", [int(o) for o in generated[0, :16]])
    return {"cfg": cfg, "model": model, "params": params, "prompt": tokens.cpu(),
            "fed": torch.stack(fed, dim=1).cpu(), "generated": generated, "prompt_s": t_prefill,
            "decode_s": t_gen, "tok_s": toks_s, "p50_s": p50, "p99_s": p99, "stats": stats,
            "graph": None if captured is None else captured.stats()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    # LM mode (the reference's flags)
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0: the config's)")
    ap.add_argument("--graph", action=argparse.BooleanOptionalAction, default=None,
                    help="serve every step through one decode step captured in a CUDA "
                         "graph, and a traffic mix's healthy tiles through captured lanes "
                         "(default on the card; needs it: the LM loop takes --no-graph on "
                         "the host, a traffic mix is eager there)")
    ap.add_argument("--dispatch-impl", default=None,
                    choices=["sort", "onehot", "coo", "bsr", "grouped"],
                    help="the MoE dispatch lane (default: the config's)")
    # sparse serving mode (selects it when given)
    ap.add_argument("--traffic", default=None, choices=["hot", "churn", "mixed"],
                    help="serve a sparse traffic mix through the ServeEngine "
                         "instead of the LM loop")
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
                    help="where the model, tenants and right-hand sides live (default cuda)")
    args = ap.parse_args(argv)
    if args.tune_mode == "none":
        args.tune_mode = None
    if args.traffic:
        serve_traffic(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
