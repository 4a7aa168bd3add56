"""The serving engine's two lanes captured in CUDA graphs: the port's form
of the reference's jitted lanes (``repro.serve.engine``)::

    self._mv = jax.jit(lambda op, x: op @ x)
    self._mm = jax.jit(lambda op, xs: op.batched_matvec(xs))

XLA's jit cache keys on the operator's *structure* (its container's
treedef, the policy, the operand's shape), so every tenant of one
structure shares a compiled program. A CUDA graph bakes in the addresses
of the operator's tensors, so the port keeps one :class:`CapturedLane` per
admitted operator, lane, width, rhs dtype and executed policy, beside the
operator in the warm pool (``SpmvWorkspace.lanes``): an eviction, a
``discard`` or a replacement of the entry drops its graphs, and a
readmission captures again.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.capture import capture
from repro_torch.core.operator import SparseOperator

LANES = ("mv", "mm")


def _on_card(op: SparseOperator) -> bool:
    return op.device.type == "cuda"


class CapturedLane:
    """``op @ x`` (lane ``"mv"``) or ``op.batched_matvec(xs)`` (lane
    ``"mm"``, ``k`` right-hand sides) captured once and replayed for every
    tile of that width.

    Construction allocates the static input, ``(ncols,)`` or ``(k,
    ncols)`` of ``dtype`` on the operator's device, and captures the lane
    through :func:`repro_torch.capture.capture`, whose warm-up builds every
    first-call cache (the ``"resident"`` and ``"tiled"`` plans, the COO row
    sort, ``segment_reduce``'s check). A call copies the tile's right-hand
    sides into the static input (one ``torch.stack(..., out=)``), replays,
    and returns a clone of the output, ``(nrows,)`` or ``(k, nrows)``: the
    next replay overwrites the static output. The graph holds the eager
    lane's kernels in its order, so a replay gives the eager tile's bits.

    Python runs only at the warm-up and the capture: dispatch's
    ``record_success``, the kernel wrappers' ``launches`` and a fault
    plan's sites count those two calls, never a replay; ``launches`` holds
    the graph's kernel launches a tile.

    Raises:
        ValueError: an unknown lane, or the operator lies off the card (the
            eager lane is the caller's choice, never a stand-in).
        RuntimeError: the capture failed (a host read, an operation a
            capture does not take).
    """

    def __init__(self, op: SparseOperator, lane: str, k: int, dtype: torch.dtype):
        if lane not in LANES:
            raise ValueError(f"CapturedLane: lane must be one of {LANES}, got {lane!r}")
        if lane == "mv" and k != 1:
            raise ValueError(f"CapturedLane: the mv lane takes one rhs, got k={k}")
        if not _on_card(op):
            raise ValueError(f"CapturedLane captures a CUDA graph and needs the operator on a "
                             f"CUDA device, got {op.device}; serve it eagerly instead")
        self.lane, self.k, self.dtype = lane, int(k), dtype
        ncols = int(op.shape[1])
        self.x = torch.zeros((ncols,) if lane == "mv" else (self.k, ncols), dtype=dtype,
                             device=op.device)
        fn = (lambda: op @ self.x) if lane == "mv" else (lambda: op.batched_matvec(self.x))
        cap = capture(fn, op.device, f"the {lane} lane of a {op.format} operator (k={k})")
        self.graph, self.out = cap.graph, cap.out
        self.capture_s, self.instantiate_s = cap.capture_s, cap.instantiate_s
        self.nodes, self.launches = cap.nodes, cap.launches

    def __call__(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The lane's output for the right-hand sides ``xs`` (``k`` vectors
        of ``ncols``, already validated by the caller)."""
        if len(xs) != self.k:
            raise ValueError(f"CapturedLane was captured for {self.k} right-hand sides, "
                             f"got {len(xs)}")
        if self.lane == "mv":
            self.x.copy_(xs[0])
        else:
            torch.stack(list(xs), out=self.x)
        self.graph.replay()
        return self.out.clone()
