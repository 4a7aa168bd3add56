"""Training launcher: the port of ``repro.launch.train``.

  python -m repro_torch.launch.train --arch llama3.2-1b --smoke \
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu
  python -m repro_torch.launch.train --arch qwen3-moe-235b-a22b --layers 1 \
      --dispatch-impl bsr --steps 5
  torchrun --nproc-per-node=<cards> -m repro_torch.launch.train --mesh local ...
  torchrun --nproc-per-node=4 -m repro_torch.launch.train --mesh local --device cpu ...

The reference's flags, plus the port's: ``--device`` (default the card),
``--layers`` (cut the model's depth, Jamba's in whole periods) and
``--dispatch-impl`` (the MoE lane), as ``repro_torch.launch.serve`` has
them. As in ``serve_lm``, the sparse products run under
``use_backend("cuda")``: the hand-written kernels on the card (``bsr_spmm``
and its backward kernels on the 'bsr' lane), their plain versions on host
tensors. Only ``bsr_spmm`` has a backward on the card, so the 'coo' lane
trains there through ``examples/train_lm_torch.py --spmv-backend plain``.

``--mesh local`` trains on a ``DeviceMesh`` of every rank that ``torchrun``
started (a lone process is a world of one), all on the first axis:
``(world, 1)`` over ``("data", "model")``, as the reference's
``make_local_mesh`` puts every device on its first axis; NCCL with one rank
a card, or ``gloo`` with ``--device cpu``. ``--mesh prod`` and ``--mesh
multi`` are the production meshes, (16, 16) and (2, 16, 16), and need a
world of 256 or 512 ranks. ``--mesh none`` (the default) trains on one
device with no mesh.

On one card the step runs captured in one CUDA graph (the first step of
the run is its warm-up, every later step a replay; see
``repro_torch.train.CapturedTrainStep``), as the reference runs its jitted,
donated step: with no mesh, and on ``--mesh local`` in a lone process (a
(1, 1) NCCL mesh: the graph holds the DTensors' local tensors);
``--no-graph`` runs every step eagerly. ``--device cpu`` (and its ``gloo``
mesh) trains eagerly and ``--graph`` raises there; a mesh of several cards
trains eagerly by default and ``--graph`` raises there too (a capture that
records NCCL collectives has not been run on one). The start-up line says
which.

``main`` sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` where the environment has
none, before the first product, so that cuBLAS takes its deterministic
workspace (see ``repro_torch.train.trainer``).
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs import list_archs
from repro_torch.core import use_backend
from repro_torch.launch.mesh import device_mesh, make_production_mesh, mesh_chips
from repro_torch.launch.serve import lm_config
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves


def train_mesh(kind: str, device="cuda"):
    """The ``DeviceMesh`` of ``--mesh`` (``None`` for ``"none"``)."""
    if kind == "none":
        return None
    if kind == "local":
        world = int(os.environ.get("WORLD_SIZE", 1))
        return device_mesh(("data", "model"), (world, 1), device)
    m = make_production_mesh(multi_pod=kind == "multi")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != mesh_chips(m):
        raise ValueError(f"--mesh {kind} needs {mesh_chips(m)} ranks, torchrun started {world}")
    return device_mesh(m.axis_names, m.sizes, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="none", choices=["none", "local", "prod", "multi"],
                    help="none: one device; local: (world, 1) over (data, model) from the "
                         "ranks torchrun started; prod/multi: the production meshes (256 or "
                         "512 ranks)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0: the config's)")
    ap.add_argument("--dispatch-impl", default=None,
                    choices=["sort", "onehot", "coo", "bsr", "grouped"],
                    help="the MoE dispatch lane (default: the config's)")
    ap.add_argument("--device", default="cuda",
                    help="where the model, its state and the batches live (default cuda)")
    ap.add_argument("--graph", action=argparse.BooleanOptionalAction, default=None,
                    help="train through one step captured in a CUDA graph (default on one "
                         "card, with no mesh or a mesh of one rank; needs it: the host, a gloo "
                         "mesh and a mesh of several cards train eagerly)")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    cfg = lm_config(args)
    tcfg = TrainerConfig(n_steps=args.steps, global_batch=args.batch,
                         seq_len=args.seq, microbatches=args.microbatches,
                         ckpt_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every)
    ocfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    tr = Trainer(cfg, tcfg, ocfg, mesh=train_mesh(args.mesh, args.device), device=args.device,
                 graph=args.graph)
    n_params = sum(x.numel() for x in leaves(tr.state[0]))
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params:,} steps={args.steps} "
          f"batch={args.batch}x{args.seq} mesh={args.mesh} device={tr.device} "
          f"graph={'on' if tr.graph else 'off'}")
    with use_backend("cuda"):
        hist = tr.train(resume=args.resume)
    if tr.captured is not None:
        st = tr.captured.stats()
        print(f"train graph: capture={st['capture_s']:.3f}s "
              f"instantiate={st['instantiate_s']:.3f}s nodes={st['nodes']} "
              f"launches a step={st['launches']}")
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(first {hist[0]['loss']:.4f}); median step "
          f"{1e3*sorted(h['time_s'] for h in hist)[len(hist)//2]:.0f}ms")
    return hist


if __name__ == "__main__":
    main()
