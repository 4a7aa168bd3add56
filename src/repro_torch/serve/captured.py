"""The LM decode step captured in one CUDA graph: the port's form of the
reference's ``jax.jit(model.decode_step, donate_argnums=(2,))``
(``repro.launch.serve``).

The reference traces the position, so one compiled program serves every
prompt and generation step, and it donates the caches, which XLA then
updates in place. Here the position is a 0-dim int64 tensor on the card,
the caches are the graph's static buffers (written in place by every
replay), and one graph serves every step of a batch of requests.
"""
from __future__ import annotations

import torch

from repro_torch.capture import capture
from repro_torch.models.model import cache_positions, reset_caches
from repro_torch.tree import leaves


class CapturedDecode:
    """``model.decode_step(params, token, caches, pos)`` at a fixed batch,
    captured once and replayed for every position.

    Construction warms the step up on a side stream and captures one more
    step with a static ``(batch, 1)`` int32 token and a 0-dim int64
    position (:func:`repro_torch.capture.capture`), then zeroes ``caches``
    (:func:`repro_torch.models.model.reset_caches`): the warm-up wrote a KV
    slot and advanced every recurrent state, and the first served token
    must see the zero caches the eager loop starts from. A call copies the
    token and the position in, replays the graph and returns a clone of
    the step's logits; the caches carry the state to the next call. The
    graph holds the eager step's kernels in its order, so a replay gives
    the eager step's bits. ``reset_caches(step.caches)`` zeroes the caches
    for a new batch of requests, at the same addresses.

    Python runs only at the warm-up and the capture: kernel wrappers'
    ``launches``, the health registry and any recorder count those two
    steps, never a replay; ``launches`` holds the graph's kernel launches
    a step.

    Raises:
        ValueError: the model or a cache lies off the card (the eager step
            is the caller's choice, never a stand-in).
        RuntimeError: the capture failed (a host read, an operation a
            capture does not take).
    """

    def __init__(self, model, params, caches, batch: int):
        dev = torch.device(model.device)
        off = {str(t.device) for t in leaves(caches) if t.device.type != "cuda"}
        if dev.type != "cuda" or off:
            raise ValueError(f"CapturedDecode captures a CUDA graph and needs the model and "
                             f"its caches on a CUDA device, got {dev} and {sorted(off)}; "
                             f"call model.decode_step eagerly instead")
        self.caches = caches
        #: positions the caches hold (None: no per-position cache, RWKV-6)
        self.smax = cache_positions(caches)
        self.token = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self._captured = cap = capture(
            lambda: model.decode_step(params, self.token, caches, self.pos)[0], dev,
            "the decode step")
        reset_caches(caches)
        self.graph, self.logits = cap.graph, cap.out
        self.capture_s, self.instantiate_s = cap.capture_s, cap.instantiate_s
        self.nodes, self.launches = cap.nodes, cap.launches

    def __call__(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        """The logits ``(batch, vocab)`` of the step that feeds ``token``
        ``(batch, 1)`` at position ``pos``, written into the caches."""
        if self.smax is not None and not 0 <= pos < self.smax:
            # the reference's dynamic_update_slice clamps; an index_copy_
            # out of range is a device assert
            raise ValueError(f"position {pos} outside the caches' {self.smax} positions")
        if token.shape != self.token.shape:
            raise ValueError(f"CapturedDecode was captured for tokens "
                             f"{tuple(self.token.shape)}, got {tuple(token.shape)}")
        self.token.copy_(token)
        self.pos.fill_(pos)
        self.graph.replay()
        return self.logits.clone()

    def stats(self) -> dict:
        return self._captured.stats()
