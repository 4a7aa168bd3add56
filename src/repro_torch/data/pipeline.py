"""Deterministic synthetic token pipeline, resumable: the port of
``repro.data.pipeline``.

Counter-based RNG (numpy's Philox keyed on (seed, step)) makes every batch a
pure function of the step index, so resuming from a checkpoint's data state
replays the exact stream with no stored cursor files. ``batch_at`` is the
reference's numpy code, so both packages give the same arrays bit for bit;
``_put`` moves a batch onto the trainer's device, and on a ``DeviceMesh``
makes each entry a DTensor split along the batch over the ``batch`` rule's
axes (the reference's ``spec_for(shape, ("batch", None, ...))``). Every
rank makes the same batch, so each keeps its chunk and nothing is sent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.core.formats import resolve_device


@dataclass
class DataState:
    step: int = 0

    def to_dict(self):
        return {"step": int(self.step)}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class SyntheticTokens:
    """Language-modelling batches: {'tokens': (B,S), 'targets': (B,S)} where
    targets are tokens shifted by one over a deterministic Zipf-ish stream.
    Optional vision/audio stub tensors for the vlm/audio families. Batches
    land on ``device`` (default the card; ``"cpu"`` for the host)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, mesh=None, frontend: str = "none",
                 frontend_tokens: int = 0, d_model: int = 0, device="cuda"):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.mesh = mesh
        self.frontend = frontend
        self.frontend_tokens = frontend_tokens
        self.d_model = d_model
        self.device = resolve_device(device)
        self.state = DataState()

    def _rng(self, step: int) -> np.random.Generator:
        # per-step Philox *key* (not counter): independent streams, pure
        # function of (seed, step)
        key = np.array([np.uint64(self.seed), np.uint64(step)], dtype=np.uint64)
        return np.random.Generator(np.random.Philox(key=key))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S = self.global_batch, self.seq_len
        # zipf-flavoured ids: realistic skew, cheap to generate
        raw = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        toks = (raw % (self.vocab - 2)) + 1
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "targets": toks[:, 1:].astype(np.int32)}
        if self.frontend == "vision":
            batch["patches"] = rng.standard_normal(
                (B, self.frontend_tokens, self.d_model)).astype(np.float32)
        if self.frontend == "audio":
            batch["frames"] = rng.standard_normal(
                (B, self.frontend_tokens, self.d_model)).astype(np.float32)
        return batch

    def _put(self, batch) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in batch.items()}
        if self.mesh is None:
            return out
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.distributed.sharding import named_sharding

        return {k: distribute_tensor(v, self.mesh, named_sharding(
                    v.shape, ("batch",) + (None,) * (v.ndim - 1), self.mesh),
                    src_data_rank=None)
                for k, v in out.items()}

    def __iter__(self):
        return self

    def __next__(self):
        b = self._put(self.batch_at(self.state.step))
        self.state = DataState(self.state.step + 1)
        return b

    def resume(self, state: DataState):
        self.state = DataState(state.step)
        return self
