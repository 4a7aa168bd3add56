"""Multi-tenant SpMV/SpMM serving — the request path over the operator
cache, as ``repro.serve``.

Requests carrying ``(matrix_or_fingerprint, rhs)`` enter a queue
(``ServeEngine.submit``), are grouped per operator and coalesced into SpMM
tiles (``batcher``), admitted into the ``SpmvWorkspace`` LRU warm pool with
zero-run tuning on first sight, and served with per-request/per-batch
accounting (``stats``). ``traffic`` generates the seeded request mixes;
``python -m repro_torch.launch.serve --traffic hot`` drives one on the card.
``CapturedLane`` is one of the engine's two serving lanes (``op @ x``,
``op.batched_matvec(xs)``) captured in a CUDA graph for one admitted
operator, as the engine serves healthy tiles on the card;
``CapturedDecode`` is the LM decode step captured in one CUDA graph, as
``launch/serve.py``'s LM loop serves it on the card.
"""
from .batcher import (
    BIT_STABLE_BACKENDS,
    ServeRequest,
    Tile,
    coalescible,
    plan_batches,
)
from .captured import CapturedDecode
from .lanes import CapturedLane
from .engine import ServeEngine, ServeError, Ticket
from .stats import BatchRecord, RequestRecord, ServeStats
from .traffic import MIXES, TrafficGenerator, TrafficSpec, matrix_pool, run_traffic

__all__ = [
    "BIT_STABLE_BACKENDS", "ServeRequest", "Tile", "coalescible", "plan_batches",
    "CapturedDecode", "CapturedLane",
    "ServeEngine", "ServeError", "Ticket",
    "BatchRecord", "RequestRecord", "ServeStats",
    "MIXES", "TrafficGenerator", "TrafficSpec", "matrix_pool", "run_traffic",
]
