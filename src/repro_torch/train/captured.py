"""The train step captured in one CUDA graph: the port's form of the
reference's ``jax.jit(step_fn, donate_argnums=(0, 1))`` and, on a mesh, of
its ``jax.jit(step_fn, in_shardings=(pshard, oshard, None),
out_shardings=..., donate_argnums=(0, 1))`` (``repro.train.trainer``).

The reference compiles the step once and donates the params and the
optimizer state, which XLA then updates in place. Here the step of
``make_train_step`` already writes the params and the AdamW state in
place; the graph keeps them as its static buffers, reads each batch from
static tensors that a call refills, and writes its metrics into static
0-dim tensors. At full width (qwen3-moe-235b-a22b, one layer, f32 AdamW)
the state is 44.8 GB: there is room for one copy of it and no snapshot.

On a ``DeviceMesh`` the params, the AdamW state and the batch are
DTensors: the graph holds their local tensors, a call copies the next
batch's local shards into the static batch's (no redistribute, no DTensor
dispatch), and the warm-up carries DTensor's first sharding propagation,
so the capture records only the kernels of the second step. The caller
runs it inside ``sharding_context(mesh)``, as the eager mesh step runs
(the ``Trainer`` does), and every local tensor lies on one CUDA device.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.capture import capture
from repro_torch.tree import leaves


class CapturedTrainStep:
    """``step(params, opt_state, batch)`` (``make_train_step``'s) captured
    once at the batch's shapes and replayed for every later step.

    Construction copies ``batch`` into static tensors, runs the step on
    them eagerly on a side stream (the warm-up: a real step, which writes
    the params and the state and whose metrics are :attr:`warm`), then
    captures one more step in a CUDA graph and instantiates it
    (:func:`repro_torch.capture.capture`). The capture runs no kernel, so
    the first replay is the step after the warm-up. A call copies the next
    batch in, replays the graph, and returns the step's metrics (``loss``,
    ``grad_norm``, ``lr``) as clones; the params and state carry the run
    to the next call. The graph holds the eager step's kernels in its
    order, so a replay gives the eager step's bits. Whatever writes the
    params or the state between replays (a restore) must write into the
    same tensors: the graph holds their addresses.

    Python runs only at the warm-up and the capture: kernel wrappers'
    ``launches`` count those two steps, never a replay; :attr:`launches`
    holds the graph's hand-written kernel launches a step.

    Raises:
        ValueError: the model, a parameter, a leaf of the state or a batch
            entry (a DTensor's local tensor) lies off the card (the eager
            step is the caller's choice, never a stand-in), or a call's
            batch has another layout (keys, shapes, dtypes, placements) than
            the captured one.
        repro_torch.capture.CaptureError: the capture failed (a host read,
            an operation a capture does not take); nothing runs eagerly in
            its place.
    """

    def __init__(self, model, step, params, opt_state, batch: Dict[str, torch.Tensor]):
        dev = torch.device(model.device)
        off = sorted({str(_local(t).device) for t in leaves((params, opt_state, batch))
                      if _local(t).device.type != "cuda"})
        if dev.type != "cuda" or off:
            raise ValueError(f"CapturedTrainStep captures a CUDA graph and needs the model, "
                             f"its params, their optimizer state and the batch on a CUDA "
                             f"device, got {dev} and {off}; call the step eagerly instead")
        self.batch = {k: v.clone() for k, v in batch.items()}
        self._captured = cap = capture(lambda: step(params, opt_state, self.batch)[2], dev,
                                       "the train step", keep_warm=True)
        #: the warm-up step's metrics (0-dim device tensors)
        self.warm = cap.warm
        self.graph, self.metrics = cap.graph, cap.out
        self.capture_s, self.instantiate_s = cap.capture_s, cap.instantiate_s
        self.nodes, self.launches = cap.nodes, cap.launches

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The metrics of one more step, on ``batch`` (the captured keys,
        shapes and dtypes; on the card or the host)."""
        if batch.keys() != self.batch.keys() or any(
                _layout_of(batch[k]) != _layout_of(v) for k, v in self.batch.items()):
            raise ValueError(f"CapturedTrainStep was captured for a batch of "
                             f"{_layout(self.batch)}, got {_layout(batch)}")
        for k, v in self.batch.items():
            _local(v).copy_(_local(batch[k]))
        self.graph.replay()
        return {k: v.clone() for k, v in self.metrics.items()}

    def stats(self) -> dict:
        return self._captured.stats()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (this rank's shard), or ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _layout_of(t: torch.Tensor) -> tuple:
    out = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    placements = getattr(t, "placements", None)     # a DTensor's
    return out if placements is None else out + (str(tuple(placements)),)


def _layout(batch) -> dict:
    return {k: _layout_of(v) for k, v in batch.items()}
