"""Serving-side observability: per-request and per-batch records + summary,
as ``repro.serve.stats`` (pure Python, a copy of the reference's).

The engine (``repro_torch.serve.engine``) appends one :class:`RequestRecord`
per served request and one :class:`BatchRecord` per executed batch; this
module turns them into the latency/throughput summary. Percentiles
use the nearest-rank method over the recorded latencies, so a summary over a
deterministic (fake-clock) run is itself deterministic.

Counter invariants (asserted by ``tests/test_torch_serve.py``):

  - ``requests == len(request records) == sum(batch sizes)``
  - ``cache_hits + cache_misses == admissions`` (one admission per
    (fingerprint, flush) group)
  - ``coalesced_requests <= requests``; every batch size is ``<= max_batch``
  - ``0 <= queue_wait_s <= latency_s`` per request, so ``p50 <= p99``

Failed requests (``ok=False``) land in ``failures``, *not* ``requests`` —
the invariants above stay exact under faults, and ``availability`` is
``served / (served + failed)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class RequestRecord:
    """One finished request — served (``ok``) or resolved to an error."""

    rid: int
    fingerprint: str
    batch_size: int          # requests coalesced into the tile that served it
    cache_hit: bool          # warm-pool hit at admission time
    coalesced: bool          # served by the SpMM tile (vs per-request SpMV)
    queue_wait_s: float      # submit -> batch execution start
    latency_s: float         # submit -> result ready
    ok: bool = True          # False: the ticket resolved to a ServeError
    error_kind: Optional[str] = None  # "deadline"|"admission"|"input"|"execution"
    degraded: bool = False   # served off the preferred backend by the breaker
    retries: int = 0         # extra attempts the retry-with-degradation spent


@dataclass(frozen=True)
class BatchRecord:
    """One executed batch (a tile of coalesced requests, or a single one)."""

    fingerprint: str
    size: int
    coalesced: bool
    cache_hit: bool
    exec_s: float            # wall time for the whole tile, device included


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile over an ascending list (0 when empty):
    the value at 1-based rank ``ceil(p/100 * n)``, i.e. the smallest value
    with at least ``p%`` of the sample at or below it."""
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    k = max(0, min(n - 1, math.ceil(p / 100.0 * n) - 1))
    return sorted_vals[k]


@dataclass
class ServeStats:
    """Accumulator the engine feeds; ``summary()`` is the reporting surface."""

    requests: List[RequestRecord] = field(default_factory=list)
    batches: List[BatchRecord] = field(default_factory=list)
    admissions: int = 0        # (fingerprint, flush) groups processed
    cache_hits: int = 0        # warm-pool hits among those
    cache_misses: int = 0      # cold admissions (operator built + tuned)
    tunes: int = 0             # admission builds that ran tune()
    dispatch_fallbacks: int = 0  # admitted operators whose selected backend
    #                              differs from the tuned policy's preference
    refreshes: int = 0         # DeltaOverlay refresh() calls processed
    refresh_retunes: int = 0   # refreshes whose drift crossed the threshold
    #                            (tune re-ran, fingerprint re-admitted)
    refresh_reselects: int = 0  # retunes that changed (format, backend)
    # -- resilience lane ----------------------------------------------------
    failures: List[RequestRecord] = field(default_factory=list)
    errors: int = 0            # tickets resolved to a ServeError
    error_kinds: Dict[str, int] = field(default_factory=dict)
    deadline_misses: int = 0   # requests expired before execution
    degraded_requests: int = 0  # served off the preferred backend (breaker)
    retries: int = 0           # per-request retry-with-degradation attempts
    batch_splits: int = 0      # coalesced tiles that failed and re-ran split
    plan_failures: int = 0     # flushes that fell back to trivial planning
    admission_retries: int = 0  # admission rebuild attempts after a failure
    admission_failures: int = 0  # individual admission build failures

    # -- feeding ------------------------------------------------------------

    def record_admission(self, hit: bool, tuned: bool, fallback: bool) -> None:
        self.admissions += 1
        self.cache_hits += hit
        self.cache_misses += not hit
        self.tunes += tuned
        self.dispatch_fallbacks += fallback

    def record_error(self, rec: RequestRecord) -> None:
        """A request resolved to a structured error (never lands in
        ``requests`` — the served-side invariants stay exact)."""
        self.failures.append(rec)
        self.errors += 1
        kind = rec.error_kind or "unknown"
        self.error_kinds[kind] = self.error_kinds.get(kind, 0) + 1
        if kind == "deadline":
            self.deadline_misses += 1

    def record_refresh(self, retuned: bool, reselected: bool) -> None:
        self.refreshes += 1
        self.refresh_retunes += retuned
        self.refresh_reselects += reselected

    def record_batch(self, batch: BatchRecord,
                     reqs: List[RequestRecord]) -> None:
        self.batches.append(batch)
        self.requests.extend(reqs)

    # -- reporting ----------------------------------------------------------

    def latency_percentile(self, p: float) -> float:
        return _percentile(sorted(r.latency_s for r in self.requests), p)

    def queue_wait_percentile(self, p: float) -> float:
        return _percentile(sorted(r.queue_wait_s for r in self.requests), p)

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.admissions if self.admissions else 0.0

    @property
    def mean_batch_size(self) -> float:
        return (sum(b.size for b in self.batches) / len(self.batches)
                if self.batches else 0.0)

    @property
    def coalesced_fraction(self) -> float:
        """Fraction of requests served inside a multi-request SpMM tile."""
        n = len(self.requests)
        return sum(r.coalesced for r in self.requests) / n if n else 0.0

    @property
    def availability(self) -> float:
        """Served / finished — 1.0 when every ticket resolved to a result."""
        total = len(self.requests) + self.errors
        return len(self.requests) / total if total else 1.0

    @property
    def degraded_fraction(self) -> float:
        """Fraction of *served* requests that ran on a degraded lane."""
        n = len(self.requests)
        return self.degraded_requests / n if n else 0.0

    def throughput(self, wall_s: float) -> float:
        return len(self.requests) / wall_s if wall_s > 0 else 0.0

    def summary(self, wall_s: float = 0.0) -> Dict:
        """The per-mix record (the reference's ``BENCH_serve.json`` keys)."""
        sizes = [b.size for b in self.batches]
        return {
            "requests": len(self.requests),
            "batches": len(self.batches),
            "admissions": self.admissions,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "hit_rate": self.hit_rate,
            "tunes": self.tunes,
            "dispatch_fallbacks": self.dispatch_fallbacks,
            "refreshes": self.refreshes,
            "refresh_retunes": self.refresh_retunes,
            "refresh_reselects": self.refresh_reselects,
            "batch_size_mean": self.mean_batch_size,
            "batch_size_max": max(sizes) if sizes else 0,
            "coalesced_fraction": self.coalesced_fraction,
            "latency_p50_s": self.latency_percentile(50),
            "latency_p99_s": self.latency_percentile(99),
            "queue_wait_p50_s": self.queue_wait_percentile(50),
            "queue_wait_p99_s": self.queue_wait_percentile(99),
            "wall_s": wall_s,
            "throughput_rps": self.throughput(wall_s),
            "errors": self.errors,
            "error_kinds": dict(self.error_kinds),
            "availability": self.availability,
            "deadline_misses": self.deadline_misses,
            "degraded_requests": self.degraded_requests,
            "degraded_fraction": self.degraded_fraction,
            "retries": self.retries,
            "batch_splits": self.batch_splits,
            "plan_failures": self.plan_failures,
            "admission_retries": self.admission_retries,
            "admission_failures": self.admission_failures,
        }
