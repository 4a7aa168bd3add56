"""End-to-end training driver of the PyTorch port: a ~100M-parameter
llama-family model, a few hundred steps, with checkpointing, fault
tolerance and data replay; the counterpart of ``examples/train_lm.py``.

  PYTHONPATH=src python examples/train_lm_torch.py --quick --device cpu  # host smoke
  PYTHONPATH=src python examples/train_lm_torch.py --quick --inject-failure
  PYTHONPATH=src python examples/train_lm_torch.py                       # ~107M, 300 steps

Runs on the card unless ``--device cpu``; there every step after the
first replays one captured CUDA graph, and ``--no-graph`` runs them
eagerly (the host always does). ``--spmv-backend`` is the
backend of the sparse products traced under the train step (MoE dispatch,
sparsified layers); on the card only ``bsr_spmm`` has a backward kernel.
``CUBLAS_WORKSPACE_CONFIG`` is set, where unset, before the first product,
so that the trainer's restart on the card replays the same bits.
"""
import argparse
import contextlib
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.core import use_backend
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="llama-104m", family="dense",
        n_layers=13, d_model=640, n_heads=10, n_kv_heads=5, head_dim=64,
        d_ff=2560, vocab=32768, tie_embeddings=True, remat="none")


def model_tiny() -> ModelConfig:
    return ModelConfig(
        name="llama-6m", family="dense",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=2048, tie_embeddings=True, remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny model, 30 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--spmv-backend", default=None, choices=["plain", "cuda", "dense"],
                    help="ExecutionPolicy backend for sparse ops (MoE dispatch, "
                         "sparsified layers) under the train step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--graph", action=argparse.BooleanOptionalAction, default=None,
                    help="replay one captured train step (default on the card; needs it)")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    cfg = model_tiny() if args.quick else model_100m()
    steps = args.steps or (30 if args.quick else 300)
    seq = 64 if args.quick else args.seq
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_torch_")
    tcfg = TrainerConfig(n_steps=steps, global_batch=args.batch, seq_len=seq,
                         ckpt_dir=ckpt_dir, checkpoint_every=max(10, steps // 10),
                         log_every=max(1, steps // 20))
    tr = Trainer(cfg, tcfg, adamw.AdamWConfig(total_steps=steps, warmup_steps=steps // 20),
                 device=args.device, graph=args.graph)
    n = sum(x.numel() for x in leaves(tr.state[0]))
    print(f"model={cfg.name} params={n/1e6:.1f}M steps={steps} "
          f"tokens/step={args.batch * seq} device={tr.device} "
          f"graph={'on' if tr.graph else 'off'}")
    scope = use_backend(args.spmv_backend) if args.spmv_backend else contextlib.nullcontext()
    with scope:
        hist = tr.train(fail_at=steps * 2 // 3 if args.inject_failure else None)
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; "
          f"median step {1e3*sorted(h['time_s'] for h in hist)[len(hist)//2]:.0f}ms; "
          f"straggler flags={tr.straggler.flagged}")
    return hist


if __name__ == "__main__":
    main()
