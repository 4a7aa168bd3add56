"""Trainer: model + optimizer + data + checkpoints + fault tolerance: the
port of ``repro.train.trainer``.

Drives ``make_train_step`` on one device (default the card; ``"cpu"`` for
the host), or on a ``DeviceMesh`` (``mesh=``, as the reference's jit with
``params_shardings``): params drawn on every rank and kept as DTensors of
their placements, the AdamW moments (and master) in the same placements,
every step on batches split over the batch axes, under
``sharding_context(mesh)``. ``save`` gathers each leaf on every rank and
rank 0 writes; ``restore`` writes each rank's chunk of the checkpoint into
the live leaves (see below). Failure injection
(``fail_at``) exercises the Supervisor restart path for real: the failed
step raises, the Supervisor restores the latest
checkpoint and replays data from the cursor, so the loss curves with and
without the failure match (``tests/test_torch_train.py``; on the card
``tests/test_torch_train_cuda.py`` and ``chip_smoke.py`` phase 15).

On one CUDA device the step runs captured (``graph=None``, the default, or
``graph=True``), as the reference runs it through ``jax.jit(step_fn,
donate_argnums=(0, 1))`` and, on a mesh, with its ``in_shardings`` and
``out_shardings``: the first step of each ``train`` call is the warm-up of
a :class:`CapturedTrainStep` and every later step replays its CUDA graph,
which holds the params and the AdamW state's tensors (a DTensor's local
tensor on a mesh). A CUDA ``DeviceMesh`` of one rank (``launch.train
--mesh local`` in a lone process) captures as one card does; on the host
and on a ``gloo`` mesh the step is eager and ``graph=True`` raises; on a
CUDA mesh of several ranks ``graph=None`` is eager and ``graph=True``
raises, since a capture that records NCCL collectives has not been run
(:func:`step_graph`). ``restore`` writes a checkpoint into the live
tensors (``copy_``; on a mesh into each DTensor's local shard, whose
placements must be the checkpoint's), on every run, captured or not, so
that a restart replays the same graph and the clean run's bits.
``graph=False`` runs every step eagerly. A capture that fails raises
(``repro_torch.capture.CaptureError``), past the Supervisor: nothing runs
eagerly in its place.

On the card a run trains under ``torch.use_deterministic_algorithms(True,
warn_only=True)``, set for the loop and restored after it: PyTorch then
takes its deterministic variants where an op has one, and the restart
replays the same bits. cuBLAS repeats its bits only with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (or ``:16:8``), which it reads once,
before the process's first product; so the entry points
(``repro_torch.launch.train``, ``examples/train_lm_torch.py``,
``chip_smoke.py``) set it at their start, and a ``Trainer`` on a CUDA
device warns when it is unset. The port's own kernels need neither: they
add in a fixed order.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.capture import CaptureError
from repro_torch.checkpoint.manager import CheckpointManager, config_hash
from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import resolve_device
from repro_torch.data.pipeline import DataState, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.resilience.monitor import StragglerMonitor, Supervisor
from repro_torch.train.captured import CapturedTrainStep
from repro_torch.train.steps import make_train_step
from repro_torch.distributed.sharding import params_shardings, sharding_context
from repro_torch.tree import leaves, map_with_path


@dataclass
class TrainerConfig:
    n_steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    checkpoint_every: int = 20
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    seed: int = 0
    log_every: int = 10
    async_checkpoint: bool = True


@contextlib.contextmanager
def deterministic(device: torch.device):
    """PyTorch's deterministic variants on a CUDA device (warnings, not
    errors, for an op without one), restored afterwards; nothing on the
    host, where every op already repeats its bits."""
    if device.type != "cuda":
        yield
        return
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def step_graph(graph: Optional[bool], device: torch.device, mesh=None) -> bool:
    """Whether a ``Trainer`` on ``device`` (and ``mesh``, a ``DeviceMesh`` or
    anything with its ``device_type`` and ``size()``) runs its step
    captured: ``graph=None`` captures on one CUDA device, with no mesh or
    on a CUDA mesh of one rank, and is eager elsewhere; ``graph=False`` is
    eager everywhere; ``graph=True`` captures and raises where
    ``graph=None`` would not.

    Raises:
        ValueError: ``graph=True`` on the host, on a ``gloo`` mesh, or on a
            CUDA mesh of several ranks."""
    on_mesh = " on a mesh" if mesh is not None else ""
    if device.type != "cuda":
        if graph:
            raise ValueError(f"graph=True trains through a step captured in a CUDA graph and "
                             f"needs a CUDA device, got {device}{on_mesh}; pass graph=False "
                             f"(or None) for the eager step")
        return False
    ranks = 1 if mesh is None else mesh.size()
    if ranks > 1:
        if graph:
            raise ValueError(f"graph=True on a CUDA mesh of {ranks} ranks: a captured step "
                             f"records its NCCL collectives in the graph, which has not been "
                             f"verified on a mesh of two or more cards; pass graph=False (or "
                             f"None) for the eager step")
        return False
    return graph is None or bool(graph)


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 ocfg: Optional[adamw.AdamWConfig] = None, mesh=None, device="cuda",
                 graph: Optional[bool] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.ocfg = ocfg or adamw.AdamWConfig(total_steps=tcfg.n_steps)
        self.mesh = mesh
        if mesh is not None:    # the mesh's device type decides (one card a rank)
            device = "cpu" if mesh.device_type == "cpu" else \
                torch.device("cuda", torch.cuda.current_device())
        self.device = resolve_device(device)
        #: the step runs captured (see the module docstring)
        self.graph = step_graph(graph, self.device, mesh)
        #: this run's captured step (``None`` before its first step)
        self.captured: Optional[CapturedTrainStep] = None
        if self.device.type == "cuda" and not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
            warnings.warn("Trainer: CUBLAS_WORKSPACE_CONFIG is unset, so cuBLAS may not repeat "
                          "its bits and a restart may not replay the run; set it to :4096:8 "
                          "before the process's first matrix product", RuntimeWarning,
                          stacklevel=2)
        self.model = build_model(cfg, device=self.device)
        self.data = SyntheticTokens(
            cfg.vocab, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed, mesh=mesh,
            frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
            d_model=cfg.d_model, device=self.device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, tcfg.keep_last) if tcfg.ckpt_dir else None
        self.straggler = StragglerMonitor()
        self.history: List[Dict[str, float]] = []
        self._step = make_train_step(self.model, self.ocfg, tcfg.microbatches)
        self.shardings = None
        if mesh is not None:
            self.shardings = params_shardings(self._template()[0], mesh)
        params = self.model.init(tcfg.seed, mesh=mesh, shardings=self.shardings)
        self.state = (params, adamw.init(params, self.ocfg.keep_master))

    def _template(self):
        """The params and AdamW state's shapes, on the ``meta`` device."""
        pshapes = build_model(self.cfg, device="meta").init()
        return pshapes, adamw.init(pshapes, self.ocfg.keep_master)

    def _mesh_ctx(self):
        return sharding_context(self.mesh) if self.mesh is not None else contextlib.nullcontext()

    # ------------------------------------------------------- persistence --

    def save(self, step: int, state=None):
        if self.ckpt is None:
            return
        params, opt = state if state is not None else self.state
        self.ckpt.save(step, {"params": params, "opt": opt},
                       meta={"data_state": self.data.state.to_dict(),
                             "config_hash": config_hash(self.cfg)},
                       async_=self.tcfg.async_checkpoint)

    def restore(self):
        assert self.ckpt is not None
        self.ckpt.wait()
        if self.mesh is not None:   # rank 0's write is done before any rank reads
            import torch.distributed as dist

            dist.barrier()
        step = self.ckpt.latest_step()
        if step is None:
            return self.state, 0
        man = self.ckpt.manifest(step)
        assert man["config_hash"] == config_hash(self.cfg), "checkpoint/config mismatch"
        # the template's shapes from the meta device: nothing allocated
        pshapes, oshapes = self._template()
        template = {"params": pshapes, "opt": oshapes}
        # into the live tensors: a captured step holds their addresses, and
        # a second state may not fit beside the first
        tree = {"params": self.state[0], "opt": self.state[1]}
        live = []
        map_with_path(lambda k, t: live.append((k, t)), tree)
        placed = {} if self.mesh is None else {
            f"{part}/{k}": v for k, v in self.shardings.items()
            for part in ("params", "opt/m", "opt/v", "opt/master")}
        with torch.no_grad():
            for (key, t), saved in zip(live, leaves(self.ckpt.restore(template, step))):
                self._write(key, t, saved, placed.get(key))
        self.data.resume(DataState.from_dict(man["data_state"]))
        return self.state, step

    def _write(self, key: str, live, saved, want) -> None:
        """``saved`` (a host tensor of the checkpoint) into the live leaf
        ``key``; where the mesh places the leaf (``want``, its placements)
        into the DTensor's local tensor, as the chunk of ``saved`` that this
        rank holds (every rank reads the whole checkpoint, so nothing is
        sent).

        Raises:
            ValueError: the live leaf is placed otherwise than ``want``."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        have = tuple(live.placements) if isinstance(live, DTensor) else None
        if have != (tuple(want) if want is not None else None):
            raise ValueError(f"Trainer.restore: the live leaf {key} is placed {have}, the "
                             f"checkpoint restores it to {want}")
        if want is None:
            live.copy_(saved)
        else:
            live.to_local().copy_(distribute_tensor(saved.to(self.device), self.mesh, want,
                                                    src_data_rank=None).to_local())

    # -------------------------------------------------------------- loop --

    def train(self, fail_at: Optional[int] = None, resume: bool = False):
        tcfg = self.tcfg
        start = 0
        if resume and self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.state, start = self.restore()

        failed = {"done": False}
        self.captured = None    # a run captures its own step (its policy, its batch)

        def step_fn(state, i):
            if fail_at is not None and i == fail_at and not failed["done"]:
                failed["done"] = True
                raise RuntimeError(f"injected failure at step {i}")
            t0 = time.time()
            batch = self.data._put(self.data.batch_at(i))
            self.data.state = DataState(i + 1)
            params, opt = state
            if not self.graph:
                params, opt, metrics = self._step(params, opt, batch)
            elif self.captured is None:     # step i is the warm-up
                self.captured = CapturedTrainStep(self.model, self._step, params, opt, batch)
                metrics = self.captured.warm
            else:
                metrics = self.captured(batch)
            self.state = (params, opt)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = i
            metrics["time_s"] = time.time() - t0
            self.history.append(metrics)
            if (i + 1) % tcfg.log_every == 0:
                print(f"step {i+1:5d} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {metrics['time_s']*1e3:.0f}ms",
                      flush=True)
            return (params, opt)

        sup = Supervisor(
            step_fn,
            save_fn=lambda state, i: self.save(i, state),
            restore_fn=self.restore,
            checkpoint_every=tcfg.checkpoint_every,
            straggler=self.straggler,
            fatal=(CaptureError,),
        )
        with deterministic(self.device), self._mesh_ctx():
            self.state, end = sup.run(self.state, start, tcfg.n_steps)
            if self.ckpt is not None:
                self.save(end)
                self.ckpt.wait()
        return self.history
