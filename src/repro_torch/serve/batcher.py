"""Request grouping and SpMM-tile coalescing — the pure planning half of the
serving engine, as ``repro.serve.batcher``.

``plan_batches`` is deterministic by construction: groups form in order of
each fingerprint's *first arrival*, requests stay in FIFO order inside their
group, and groups are chunked into tiles of at most ``max_batch`` requests.
Two runs over the same request sequence therefore produce the same plan.

Coalescing a tile turns ``k`` single-vector matvecs against one matrix into
one ``SparseOperator.batched_matvec``. In this package that call runs the
SpMV-per-column SpMM lane (``core/spmv.py``), so a tile of k columns still
costs k kernel launches; the win is one dispatch walk per tile. Whether a
tile *may* coalesce without breaking the bit-identity contract is
``coalescible``'s call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.core.operator import SparseOperator
from repro_torch.core.spmv import DispatchKey, dispatch_table, select_spmv

#: Backends whose SpMM lane performs each column's accumulations in the
#: single-vector kernel's order — the lanes on which a coalesced tile is
#: bit-for-bit identical to per-request SpMV.
BIT_STABLE_BACKENDS = ("plain", "cuda")


@dataclass(frozen=True)
class ServeRequest:
    """One queued matvec: ``y = A_fingerprint @ rhs``."""

    rid: int
    fingerprint: str
    rhs: Any                 # (ncols,) tensor on the engine's device
    t_submit: float
    deadline: Any = None     # absolute engine-clock deadline, or None


@dataclass(frozen=True)
class Tile:
    """A unit of execution: requests against one matrix, served together."""

    fingerprint: str
    requests: Tuple[ServeRequest, ...]

    @property
    def size(self) -> int:
        return len(self.requests)


def plan_batches(queue: Sequence[ServeRequest], max_batch: int) -> List[Tile]:
    """Group the queued requests per fingerprint and chunk into tiles.

    Deterministic: group order is first-arrival order of each fingerprint,
    request order inside a group is arrival order, tiles are consecutive
    ``max_batch``-sized chunks.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    groups: Dict[str, List[ServeRequest]] = {}
    order: List[str] = []
    for req in queue:
        if req.fingerprint not in groups:
            groups[req.fingerprint] = []
            order.append(req.fingerprint)
        groups[req.fingerprint].append(req)
    tiles: List[Tile] = []
    for fp in order:
        reqs = groups[fp]
        for i in range(0, len(reqs), max_batch):
            tiles.append(Tile(fp, tuple(reqs[i:i + max_batch])))
    return tiles


def coalescible(op: SparseOperator) -> bool:
    """True when a multi-request tile against ``op`` may run as one SpMM
    while staying bit-identical to per-request SpMV.

    Two conditions, checked against the backend dispatch will actually
    select for this operator (on the card, ``select_spmv`` orders the chain
    as dispatch does there):

      1. the backend is bit-stable (``plain``/``cuda`` — their SpMM lane is
         the SpMV kernel once per column, same accumulation order);
      2. no *native* SpMM kernel is registered for the selected
         (format, backend) cell — a fused kernel (BSR's block product, the
         dense backend's matmul) may reassociate the reduction.

    Anything else is served per-request by the engine: correctness is the
    contract, coalescing only an optimisation.
    """
    entry = select_spmv(op.container, op._effective_policy())
    backend = entry.key.backend
    if backend not in BIT_STABLE_BACKENDS:
        return False
    return DispatchKey(op.format, backend) not in dispatch_table("spmm")
