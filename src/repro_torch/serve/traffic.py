"""Seeded traffic generation for the serving engine, as
``repro.serve.traffic``: the same request streams bit for bit, built on this
package's ``core/matrices.py``.

Three mixes (the first two are the ends of the warm-pool spectrum):

  - ``"hot"``    — single-tenant hot matrix: every request targets one
    matrix, so after the first flush every admission is a warm-pool hit and
    tiles coalesce to ``max_batch``. Measures the SpMM-coalescing ceiling.
  - ``"churn"``  — multi-tenant churn: requests cycle through more distinct
    matrices than the warm pool holds, so the LRU keeps evicting and
    readmission keeps re-tuning. Measures the cold path.
  - ``"mixed"``  — 70% of requests hit one hot tenant, the rest spread over
    the churn pool (a Zipf-flavoured middle ground).

Everything is derived from the seed: the matrix pool, the per-request
tenant choice, and the right-hand sides — two generators built with the
same spec emit identical request streams (``tests/test_torch_serve.py``
holds them equal to the reference's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.core import matrices as M

MIXES = ("hot", "churn", "mixed")


def matrix_pool(n: int, n_matrices: int, seed: int = 0) -> List[Tuple[str, object]]:
    """A deterministic pool of distinct tenant matrices, cycling through the
    suite's structural archetypes (banded / random / powerlaw / tridiag) so
    churn exercises different tuned formats, not copies of one."""
    makers = [
        lambda i: (f"banded_{n}_{i}", M.banded(n, 3 + 2 * (i % 3), seed=10 + i)),
        lambda i: (f"random_{n}_{i}", M.random_uniform(n, min(0.3, 8.0 / n), seed=20 + i)),
        lambda i: (f"powerlaw_{n}_{i}", M.powerlaw(n, avg_nnz=6, seed=30 + i)),
        lambda i: (f"tridiag_{n}_{i}", M.tridiag(n, seed=40 + i)),
    ]
    return [makers[i % len(makers)](i) for i in range(n_matrices)]


@dataclass(frozen=True)
class TrafficSpec:
    """Everything a request stream is derived from."""

    mix: str = "hot"
    n: int = 96               # matrix dimension
    n_matrices: int = 8       # distinct tenants (churn/mixed pools)
    seed: int = 0
    hot_fraction: float = 0.7  # "mixed": share of requests on the hot tenant

    def __post_init__(self):
        if self.mix not in MIXES:
            raise ValueError(f"unknown mix {self.mix!r}; choose from {MIXES}")


class TrafficGenerator:
    """Iterator of ``(tenant_name, matrix, rhs)`` requests for one spec."""

    def __init__(self, spec: TrafficSpec):
        self.spec = spec
        pool_size = 1 if spec.mix == "hot" else max(2, spec.n_matrices)
        self.pool = matrix_pool(spec.n, pool_size, seed=spec.seed)
        self._rng = np.random.default_rng(spec.seed)

    def _pick(self, i: int) -> int:
        if self.spec.mix == "hot":
            return 0
        if self.spec.mix == "churn":
            # round-robin with a seeded shuffle per cycle: every tenant keeps
            # recurring, but never in a pattern the LRU could get lucky on
            cycle, slot = divmod(i, len(self.pool))
            order = np.random.default_rng((self.spec.seed, cycle)).permutation(
                len(self.pool))
            return int(order[slot])
        # mixed: biased coin per request
        if self._rng.random() < self.spec.hot_fraction:
            return 0
        return int(self._rng.integers(1, len(self.pool)))

    def requests(self, num: int) -> Iterator[Tuple[str, object, np.ndarray]]:
        for i in range(num):
            name, mat = self.pool[self._pick(i)]
            rhs = self._rng.standard_normal(self.spec.n).astype(np.float32)
            yield name, mat, rhs


def run_traffic(engine, spec: TrafficSpec, num_requests: int,
                flush_every: int = 0, on_flush=None) -> dict:
    """Drive ``engine`` with ``num_requests`` of ``spec`` traffic.

    ``flush_every`` sets the batching window (requests per flush); ``0``
    means one big window — everything queues, one flush serves it.
    ``on_flush``, when given, is called after each flush that served
    requests with that window's ``[(tenant_name, rhs, ticket)]``, so a
    caller can check what was served. Returns the engine summary for the
    run, with the spec attached.
    """
    gen = TrafficGenerator(spec)
    window = flush_every if flush_every > 0 else num_requests
    tickets = []
    pending = []

    def flush():
        engine.flush()
        if on_flush is not None and pending:
            on_flush(list(pending))
        pending.clear()

    for i, (name, mat, rhs) in enumerate(gen.requests(num_requests)):
        tickets.append(engine.submit(mat, rhs))
        pending.append((name, rhs, tickets[-1]))
        if (i + 1) % window == 0:
            flush()
    flush()
    assert all(t.done for t in tickets)
    out = engine.summary()
    out["mix"] = spec.mix
    out["n"] = spec.n
    out["n_matrices"] = len(gen.pool)
    out["seed"] = spec.seed
    out["flush_every"] = flush_every
    return out
