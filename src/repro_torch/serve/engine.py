"""The multi-tenant SpMV/SpMM serving engine — the request path over the
operator cache, as ``repro.serve.engine``.

Request lifecycle::

    submit(matrix | fingerprint, rhs)          # enqueue, never executes
        -> Ticket                              # future-like handle
    flush()                                    # the batch boundary
        1. plan: group queued requests per matrix fingerprint, chunk into
           tiles of <= max_batch (repro_torch.serve.batcher, deterministic)
        2. admit: first sight of a matrix zero-run tunes it
           (tune(mode="predict")) and inserts the operator into the
           SpmvWorkspace LRU warm pool; a warm fingerprint is a cache hit
           (recency refreshed). Capacity evicts the least-recently served
           tenant — its next appearance re-tunes on readmission.
        3. execute: a multi-request tile on a bit-stable lane runs as ONE
           SpMM (SparseOperator.batched_matvec) and the result rows are
           scattered back to their tickets bit-identically to per-request
           SpMV; other lanes serve per-request.
        4. account: per-request queue wait/latency and per-batch size,
           cache hit, exec time land in ServeStats. A tile's clock stops
           after a synchronize on its result's stream, so latencies include
           device time.

The engine holds its tenants and right-hand sides on one ``device``
(default ``"cuda"``; ``submit`` copies the rhs there once).

**Captured lanes** (``graph``, on by default on the card): the reference
serves a healthy tile through two jitted lanes, ``jax.jit(lambda op, x:
op @ x)`` and ``jax.jit(lambda op, xs: op.batched_matvec(xs))``; here each
is a CUDA graph (:class:`~repro_torch.serve.lanes.CapturedLane`) captured
on first use for one admitted operator, lane, width, rhs dtype and
executed policy, kept beside the operator in the warm pool and dropped
with it. A tile copies its right-hand sides into the graph's static
input, replays and clones the output; every replay gives the eager tile's
bits. As the reference does, a tile runs **eagerly** while a fault plan is
armed, ``check_finite`` is on, or any key is quarantined (a fault fired at
capture time would be baked into the graph, and probe and recovery
accounting need the per-call dispatch path); a per-request retry, which
follows a planted fault, is eager too. Dispatch's Python
(``record_success``, the kernel wrappers' launch counters, a plan's
sites) runs at a lane's warm-up and capture, never at a replay, as it
runs once under the reference's trace. Each rhs is checked before it
reaches a static buffer: one that is not a ``(ncols,)`` vector resolves
its own request to ``kind="input"`` and splits its tile. A capture that
fails resolves the tile's requests to ``kind="execution"``; nothing is
served eagerly in its place. ``graph_stats()`` counts captures, replays,
their seconds, nodes and live graphs (kept out of ``summary()``, whose
keys are the reference's). ``graph=False`` serves every tile eagerly.

**Degraded serving**: a flush never lets a fault take the batch down.
Failures resolve the affected tickets to a structured :class:`ServeError`
(``ticket.result()`` raises it; ``flush`` itself only propagates
programming errors like unknown fingerprints):

  - per-request **deadlines** (``submit(..., deadline_s=)``) expire before
    execution -> ``kind="deadline"``;
  - **admission** build failures retry with exponential backoff through the
    seed :class:`~repro_torch.resilience.monitor.RestartPolicy`; exhausted
    -> ``kind="admission"`` for every request on that fingerprint this
    flush;
  - a failed **coalesced tile** splits and retries per-request, so one
    poison rhs cannot fail its batch peers (``kind="input"`` for the poison
    request only);
  - a failed per-request execution gets bounded **retry-with-degradation**
    (the policy chain is extended toward plain/dense) -> ``kind="execution"``
    only when retries are exhausted;
  - the dispatch **circuit breaker** (``repro_torch.core.health``, one
    registry per engine, scoped over the flush via ``use_health``)
    quarantines a repeatedly failing (format, backend) and the tile
    retargets to the healthy lane, whose results are bit-identical to that
    lane's normal output.

On the card, dispatch runs a ``cuda`` kernel or raises: it never passes over
it for a later chain entry, quarantined or not. The engine moves off it
only for a fault the resilience lane planted (a fault plan fired during the
attempt: an ``InjectedFault`` at the kernel site, or NaNs at the non-finite
site under ``check_finite``): a retry's chain drops ``cuda``, and while the
breaker blocks the preferred ``cuda`` key the tile and each attempt run a
chain without it, each such request counted in ``retries`` /
``degraded_requests`` as the reference counts it. Any other failure of a
``cuda`` kernel on the card (a build, a launch, a ``KernelExecutionError``)
resolves the tile's requests to ``kind="execution"`` with no retry, and the
key is never served around afterwards: the plain version never stands in
for a kernel that really failed.

The engine is async-friendly by construction: ``submit`` only appends to
the queue, ``flush`` is the single execution point, and tickets are
awaitable. It is *not* thread-safe; shard across engines instead.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import health as _health
from repro_torch.core.errors import AdmissionError, KernelExecutionError, SparseInputError
from repro_torch.core.formats import resolve_device
from repro_torch.core.health import HealthRegistry, use_health
from repro_torch.core.operator import ExecutionPolicy, SparseOperator, as_operator
from repro_torch.core.registry import SpmvWorkspace
from repro_torch.core.spmv import DispatchKey, select_spmv
from repro_torch.resilience.monitor import RestartPolicy

from .batcher import ServeRequest, Tile, coalescible, plan_batches
from .lanes import CapturedLane
from .stats import BatchRecord, RequestRecord, ServeStats


def _on_card(op: SparseOperator) -> bool:
    """The operator's tensors are on a CUDA device, where dispatch runs a
    ``cuda`` kernel or raises."""
    return op.device.type == "cuda"


def _sync(y: torch.Tensor) -> torch.Tensor:
    """Wait for ``y`` on its stream (a no-op on the host)."""
    if y.is_cuda:
        torch.cuda.current_stream(y.device).synchronize()
    return y


def _fired() -> int:
    """Events the active fault plan has fired so far (0 with none armed)."""
    plan = _health.fault_plan()
    return 0 if plan is None else len(plan.events)


class ServeError(RuntimeError):
    """Structured per-request failure a :class:`Ticket` resolves to.

    ``kind`` is one of ``"deadline"`` (expired before execution),
    ``"admission"`` (warm-pool build failed after bounded retries),
    ``"input"`` (non-finite rhs / malformed container — never retried), or
    ``"execution"`` (every retry + degradation exhausted). ``cause`` keeps
    the original exception when there was one."""

    def __init__(self, kind: str, rid: int, fingerprint: str, message: str,
                 cause: Optional[BaseException] = None):
        super().__init__(f"[{kind}] request {rid} on {fingerprint[:12]}...: "
                         f"{message}")
        self.kind = kind
        self.rid = rid
        self.fingerprint = fingerprint
        self.cause = cause


class Ticket:
    """Future-like handle for one submitted request.

    ``result()`` (or ``await ticket``) returns the ``(nrows,)`` result,
    flushing the engine first when the request is still queued; a request
    that failed raises its :class:`ServeError` instead. ``record`` is the
    per-request :class:`~repro_torch.serve.stats.RequestRecord` once
    resolved, ``error`` the structured failure (``None`` when served).
    """

    __slots__ = ("rid", "_engine", "_y", "record", "error")

    def __init__(self, rid: int, engine: "ServeEngine"):
        self.rid = rid
        self._engine = engine
        self._y = None
        self.record: Optional[RequestRecord] = None
        self.error: Optional[ServeError] = None

    @property
    def done(self) -> bool:
        return self.record is not None

    @property
    def ok(self) -> bool:
        """Resolved successfully (False while pending or on error)."""
        return self.record is not None and self.error is None

    def result(self):
        if not self.done:
            self._engine.flush()
        if not self.done:  # flush ran but this rid was not in the queue
            raise RuntimeError(f"request {self.rid} was never served")
        if self.error is not None:
            raise self.error
        return self._y

    def __await__(self):
        return self.result()
        yield  # pragma: no cover — marks __await__ as a generator

    def _fulfil(self, y, record: RequestRecord) -> None:
        self._y = y
        self.record = record

    def _fail(self, error: ServeError, record: RequestRecord) -> None:
        self.error = error
        self.record = record


class ServeEngine:
    """Batched multi-tenant serving over the ``SpmvWorkspace`` warm pool.

    Args:
        capacity: warm-pool size (distinct matrices held tuned + converted);
            ignored when an explicit ``workspace`` is passed.
        workspace: share an existing :class:`SpmvWorkspace` between engines.
        policy: base :class:`ExecutionPolicy` for admitted operators
            (default: the ambient default policy).
        fmt: container format matrices are built in *before* tuning
            retargets them.
        max_batch: widest SpMM tile one flush may form per matrix.
        tune_mode: ``"predict"`` (zero-run, the serving default), ``"run"``
            (measure — pays real kernel time at admission), or ``None``
            (no tuning: serve in ``fmt`` under ``policy`` as-is).
        drift_threshold: structural-drift score at which :meth:`refresh`
            re-selects a mutated tenant's (format, backend) — see
            ``repro_torch.core.dynamic`` (with ``tune_mode=None`` refresh
            only compacts, never re-tunes).
        clock: injectable monotonic clock (tests pass a fake).
        deadline_s: default per-request deadline (``submit`` may override);
            ``None`` = no deadline.
        max_retries: extra per-request attempts after an execution failure
            (each retry extends the policy chain toward plain/dense, and on
            the card drops ``cuda`` from it; on the card only a planted
            fault is retried).
        check_finite: enforce ``ExecutionPolicy.check_finite`` on every
            served operator (inputs validated, non-finite outputs treated
            as kernel failures) — opt-in.
        health: share a :class:`~repro_torch.core.health.HealthRegistry`
            between engines; default is a per-engine registry on the
            engine's clock.
        admission_retries: admission build attempts before the fingerprint's
            requests fail with ``kind="admission"`` (per flush; a later
            flush starts a fresh attempt).
        admission_backoff_s: base of the admission retry backoff
            (``RestartPolicy`` doubles it per consecutive failure). The
            delay is *recorded* and only slept when ``sleep`` is set.
        sleep: optional ``sleep_fn`` for real backoff.
        device: where tenants built from scipy/dense input and every rhs
            live (default ``"cuda"``; raises without a card).
        graph: serve healthy tiles through captured lanes (see the module
            docstring). ``None``: on a CUDA ``device``, eager on the host;
            ``True`` on a host ``device`` raises ``ValueError``.
    """

    def __init__(self, *, capacity: int = 32,
                 workspace: Optional[SpmvWorkspace] = None,
                 policy: Optional[ExecutionPolicy] = None,
                 fmt: str = "csr", max_batch: int = 32,
                 tune_mode: Optional[str] = "predict",
                 drift_threshold: Optional[float] = None,
                 clock=time.perf_counter,
                 deadline_s: Optional[float] = None,
                 max_retries: int = 1,
                 check_finite: bool = False,
                 health: Optional[HealthRegistry] = None,
                 admission_retries: int = 2,
                 admission_backoff_s: float = 0.0,
                 sleep=None,
                 device="cuda",
                 graph: Optional[bool] = None):
        from repro_torch.core.dynamic import DEFAULT_DRIFT_THRESHOLD

        self.device = resolve_device(device)
        if graph is None:
            graph = self.device.type == "cuda"
        elif graph and self.device.type != "cuda":
            raise ValueError(f"graph=True serves through lanes captured in CUDA graphs and "
                             f"needs a CUDA device, got {self.device}; pass graph=False to "
                             f"serve every tile eagerly")
        #: healthy tiles replay captured lanes (False: every tile eager)
        self.graph = bool(graph)
        self._graphs = {"captures": 0, "replays": 0, "capture_s": 0.0,
                        "instantiate_s": 0.0, "nodes": 0}
        self.drift_threshold = (DEFAULT_DRIFT_THRESHOLD
                                if drift_threshold is None
                                else float(drift_threshold))
        self.workspace = workspace if workspace is not None \
            else SpmvWorkspace(max_entries=capacity)
        self.policy = policy
        self.fmt = fmt
        self.max_batch = int(max_batch)
        self.tune_mode = tune_mode
        self.clock = clock
        self.deadline_s = deadline_s
        self.max_retries = int(max_retries)
        self.check_finite = bool(check_finite)
        self.health = health if health is not None \
            else HealthRegistry(clock=clock)
        self.admission_retries = int(admission_retries)
        self.admission_backoff_s = float(admission_backoff_s)
        self._sleep = sleep
        self.stats = ServeStats()
        self._queue: List[ServeRequest] = []
        self._tickets: Dict[int, Ticket] = {}
        self._matrices: Dict[str, Any] = {}  # fp -> source matrix (rebuilds
        #                                      after eviction re-tune from it)
        self._admission_policies: Dict[str, RestartPolicy] = {}
        # cuda keys whose kernel failed on the card with no planted fault:
        # never served around (see the module docstring)
        self._failed_on_card: set = set()
        self._next_rid = 0
        self._t_first_submit: Optional[float] = None
        self._t_last_done: float = 0.0

    # -- request side -------------------------------------------------------

    def fingerprint(self, matrix) -> str:
        """The structural fingerprint requests may carry instead of the
        matrix itself once the engine has seen it."""
        return SpmvWorkspace.fingerprint(matrix)

    def submit(self, matrix_or_fingerprint: Union[str, Any], rhs,
               deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue ``A @ rhs``; returns a :class:`Ticket`. Never executes.

        ``matrix_or_fingerprint`` is either a matrix-like (scipy sparse,
        dense, registered container, ``SparseOperator``) or the fingerprint
        string of a matrix this engine has already seen — unknown
        fingerprints raise ``KeyError`` at flush time. ``rhs`` is copied to
        the engine's device here, once. ``deadline_s`` (relative to now on
        the engine's clock; default: the engine's ``deadline_s``) expires
        the request if execution has not *started* by then.
        """
        if isinstance(matrix_or_fingerprint, str):
            fp = matrix_or_fingerprint
        else:
            fp = self.fingerprint(matrix_or_fingerprint)
            # keep the source: eviction from the warm pool must be able to
            # rebuild + re-tune on readmission
            self._matrices.setdefault(fp, matrix_or_fingerprint)
        now = self.clock()
        if self._t_first_submit is None:
            self._t_first_submit = now
        rel = deadline_s if deadline_s is not None else self.deadline_s
        deadline = (now + rel) if rel is not None else None
        rid = self._next_rid
        self._next_rid += 1
        ticket = Ticket(rid, self)
        self._tickets[rid] = ticket
        self._queue.append(ServeRequest(rid, fp, torch.as_tensor(rhs, device=self.device),
                                        now, deadline))
        return ticket

    def __len__(self) -> int:
        return len(self._queue)

    # -- admission ----------------------------------------------------------

    def _admit(self, fp: str):
        """Warm-pool lookup/insert for one (fingerprint, flush) group;
        returns ``(operator, hit)``."""
        built = {"tuned": False}

        def build() -> SparseOperator:
            plan = _health.fault_plan()
            if plan is not None:
                plan.fire("admission", fp)
            if fp not in self._matrices:
                raise KeyError(
                    f"fingerprint {fp[:12]}... unknown: submit the matrix "
                    f"itself at least once before fingerprint-only requests")
            op = as_operator(self._matrices[fp], self.fmt, policy=self.policy,
                             device=self.device)
            if self.tune_mode is not None:
                op = op.tune(mode=self.tune_mode)
                built["tuned"] = True
            return op

        op, hit = self.workspace.admit(fp, build)
        selected = select_spmv(op.container, op._effective_policy()).key.backend
        preferred = op._effective_policy().backends[0]
        self.stats.record_admission(hit=hit, tuned=built["tuned"],
                                    fallback=selected != preferred)
        return op, hit

    def _admit_guarded(self, fp: str):
        """Admission with bounded retry + exponential backoff (the seed
        ``RestartPolicy`` drives the budget); raises :class:`AdmissionError`
        when exhausted. Unknown fingerprints are a caller bug and keep
        raising ``KeyError`` — that is not a fault to absorb."""
        pol = self._admission_policies.get(fp)
        if pol is None:
            pol = self._admission_policies[fp] = RestartPolicy(
                max_restarts=self.admission_retries,
                backoff_base_s=self.admission_backoff_s,
                clock=self.clock, sleep_fn=self._sleep)
        while True:
            try:
                out = self._admit(fp)
            except KeyError:
                raise
            except Exception as e:
                self.stats.admission_failures += 1
                if pol.on_failure() == "abort":
                    # fresh incident next flush — the docstring's "per flush"
                    self._admission_policies.pop(fp, None)
                    raise AdmissionError(
                        f"admission of {fp[:12]}... failed after "
                        f"{len(pol.history) - 1} retries: "
                        f"{type(e).__name__}: {e}") from e
                self.stats.admission_retries += 1
                continue
            pol.reset()  # a success closes the incident
            return out

    # -- execution ----------------------------------------------------------

    def _fail_request(self, req: ServeRequest, kind: str, exc,
                      t_start: float, retries: int = 0,
                      batch_size: int = 1) -> None:
        """Resolve one ticket to a structured error (never propagates)."""
        t_done = self.clock()
        self._t_last_done = max(self._t_last_done, t_done)
        rec = RequestRecord(
            rid=req.rid, fingerprint=req.fingerprint, batch_size=batch_size,
            cache_hit=False, coalesced=False,
            queue_wait_s=max(0.0, t_start - req.t_submit),
            latency_s=max(0.0, t_done - req.t_submit),
            ok=False, error_kind=kind, retries=retries)
        self.stats.record_error(rec)
        err = ServeError(kind, req.rid, req.fingerprint, str(exc),
                         cause=exc if isinstance(exc, BaseException) else None)
        self._tickets.pop(req.rid)._fail(err, rec)

    def _fail_tile(self, tile: Tile, kind: str, exc, t_start: float) -> None:
        for req in tile.requests:
            self._fail_request(req, kind, exc, t_start)

    @staticmethod
    def _degraded_policy(pol: ExecutionPolicy, on_card: bool) -> ExecutionPolicy:
        """Extend the chain toward the always-correct lanes for a retry; on
        the card drop ``cuda``, which dispatch there would run again."""
        chain = tuple(b for b in pol.backends if not (on_card and b == "cuda"))
        for b in ("plain", "dense"):
            if b not in chain:
                chain = chain + (b,)
        return pol.replace(backends=chain, allow_fallback=True)

    def _healthy_policy(self, op: SparseOperator, pol: ExecutionPolicy) -> ExecutionPolicy:
        """``pol`` as the breaker lets it run: on the card, without a
        ``cuda`` entry whose key is blocked (quarantined, cooldown running)
        by planted faults alone, which dispatch there would run all the
        same; on the host dispatch's own health order passes over it. A
        strict policy is left as it is."""
        key = DispatchKey(op.format, "cuda")
        if (not _on_card(op) or not pol.allow_fallback
                or "cuda" not in pol.backends or key in self._failed_on_card
                or not self.health.blocked(key)):
            return pol
        chain = tuple(b for b in pol.backends if b != "cuda")
        return pol.replace(backends=chain or ("plain",))

    def _real_card_failure(self, op: SparseOperator, pol: ExecutionPolicy,
                           fired_before: int) -> bool:
        """An attempt under ``pol`` failed on the card with ``cuda`` in its
        chain and no fault planted meanwhile: the kernel really failed. The
        key is remembered so that nothing serves around it."""
        if not _on_card(op) or "cuda" not in pol.backends or _fired() > fired_before:
            return False
        self._failed_on_card.add(DispatchKey(op.format, "cuda"))
        return True

    @staticmethod
    def _served_rhs(op: SparseOperator, rhs) -> torch.Tensor:
        """``rhs`` on the operator's device, checked as the eager lane checks
        it (``_operand``, then ``batched_matvec``'s ndim and columns) before
        it reaches a lane's static buffer."""
        x = op._operand(rhs)
        if x.ndim != 1 or x.shape[0] != op.shape[1]:
            raise SparseInputError(
                f"rhs of shape {tuple(x.shape)} against a {op.format} operator of shape "
                f"{tuple(op.shape)}: a served rhs is a ({op.shape[1]},) vector")
        return x

    def _replay(self, op: SparseOperator, fp: str, lane: str,
                xs: List[torch.Tensor]) -> torch.Tensor:
        """``xs`` through the operator's captured ``lane``, capturing it on
        first use (kept beside the warm-pool entry ``fp``)."""
        dtype = xs[0].dtype
        for x in xs[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
        lanes = self.workspace.lanes(fp, op)
        key = (lane, len(xs), dtype, op._effective_policy())
        captured = lanes.get(key)
        if captured is None:
            captured = CapturedLane(op, lane, len(xs), dtype)
            lanes[key] = captured
            g = self._graphs
            g["captures"] += 1
            g["capture_s"] += captured.capture_s
            g["instantiate_s"] += captured.instantiate_s
            g["nodes"] += captured.nodes
        y = captured(xs)
        self._graphs["replays"] += 1
        return y

    def _serve_captured(self, op: SparseOperator, fp: str, req: ServeRequest
                        ) -> Tuple[Optional[torch.Tensor], int, Optional[tuple]]:
        """One request through the captured ``mv`` lane: a malformed rhs is
        ``kind="input"``, any other failure ``kind="execution"`` (no retry:
        an eager retry would stand in for the lane)."""
        fired = _fired()
        try:
            x = self._served_rhs(op, req.rhs)
        except SparseInputError as e:
            return None, 0, ("input", e)
        try:
            return _sync(self._replay(op, fp, "mv", [x])), 0, None
        except Exception as e:
            self._real_card_failure(op, op._effective_policy(), fired)
            return None, 0, ("execution", e)

    def _serve_one(self, op: SparseOperator, req: ServeRequest
                   ) -> Tuple[Optional[torch.Tensor], int, Optional[tuple]]:
        """One request with bounded retry-with-degradation; returns
        ``(y, retries, error)`` where error is ``(kind, exc)`` or None."""
        pol = op._effective_policy()
        on_card = _on_card(op)
        attempt = 0
        while True:
            fired = _fired()
            run_pol = self._healthy_policy(op, pol)
            try:
                y = _sync(op.with_policy(run_pol) @ req.rhs)
                return y, attempt, None
            except SparseInputError as e:
                # poisoned input: retrying burns budget for the same answer
                return None, attempt, ("input", e)
            except Exception as e:
                if (attempt >= self.max_retries
                        or self._real_card_failure(op, run_pol, fired)):
                    return None, attempt, ("execution", e)
                attempt += 1
                self.stats.retries += 1
                pol = self._degraded_policy(pol, on_card)

    def _serve_tile(self, tile: Tile, op: SparseOperator, hit: bool) -> None:
        t_start = self.clock()
        live: List[ServeRequest] = []
        for req in tile.requests:
            if req.deadline is not None and t_start > req.deadline:
                self._fail_request(req, "deadline",
                                   "deadline expired before execution",
                                   t_start)
            else:
                live.append(req)
        if not live:
            return
        base_pol = op._effective_policy()
        if self.check_finite and not base_pol.check_finite:
            base_pol = base_pol.replace(check_finite=True)
            op = op.with_policy(base_pol)
        # Health-aware lane selection: when the breaker quarantined the
        # preferred backend, retarget the executed policy so dispatch serves
        # the healthy lane (on the card the blocked cuda entry is dropped
        # first: select_spmv there reports it whatever its health)
        degraded = False
        exec_op = op
        if self.health.any_quarantined():
            pol = self._healthy_policy(op, base_pol)
            selected = select_spmv(op.container, pol).key.backend
            if selected != base_pol.backends[0]:
                degraded = True
                exec_op = op.with_policy(base_pol.preferring(selected))
        # the reference's rule: the jitted (here captured) lanes serve the
        # healthy steady state only
        eager = (not self.graph or _health.fault_plan() is not None
                 or base_pol.check_finite or self.health.any_quarantined())
        coalesce = len(live) > 1 and coalescible(exec_op)
        results: Optional[List[tuple]] = None
        if coalesce:
            fired = _fired()
            try:
                if eager:
                    ys = _sync(exec_op.batched_matvec(torch.stack([r.rhs for r in live])))
                else:
                    xs = [self._served_rhs(exec_op, r.rhs) for r in live]
                    ys = _sync(self._replay(exec_op, tile.fingerprint, "mm", xs))
                if base_pol.check_finite and not bool(torch.isfinite(ys).all()):
                    raise KernelExecutionError(
                        "coalesced tile produced non-finite rows")
                results = [(ys[i], 0, None) for i in range(len(live))]
            except SparseInputError:
                # one poison request must not fail its batch peers: split
                # and retry per-request (kind-level blame lands below)
                self.stats.batch_splits += 1
                coalesce = False
            except Exception as e:
                # a failed capture or replay is never served eagerly instead
                if (self._real_card_failure(exec_op, exec_op._effective_policy(), fired)
                        or not eager):
                    results = [(None, 0, ("execution", e))] * len(live)
                else:
                    self.stats.batch_splits += 1
                    coalesce = False
        if results is None:
            results = [self._serve_one(exec_op, r) if eager
                       else self._serve_captured(exec_op, tile.fingerprint, r) for r in live]
        t_done = self.clock()
        self._t_last_done = max(self._t_last_done, t_done)
        served = [(req, y, nretry) for req, (y, nretry, err) in zip(live, results)
                  if err is None]
        for req, (y, nretry, err) in zip(live, results):
            if err is not None:
                kind, exc = err
                self._fail_request(req, kind, exc, t_start, retries=nretry,
                                   batch_size=len(live))
        if not served:
            return
        records = []
        for req, y, nretry in served:
            rec = RequestRecord(
                rid=req.rid, fingerprint=req.fingerprint,
                batch_size=len(served), cache_hit=hit, coalesced=coalesce,
                queue_wait_s=t_start - req.t_submit,
                latency_s=t_done - req.t_submit,
                degraded=degraded, retries=nretry)
            if degraded:
                self.stats.degraded_requests += 1
            records.append(rec)
            self._tickets.pop(req.rid)._fulfil(y, rec)
        self.stats.record_batch(
            BatchRecord(fingerprint=tile.fingerprint, size=len(served),
                        coalesced=coalesce, cache_hit=hit,
                        exec_s=t_done - t_start),
            records)

    def flush(self) -> int:
        """Serve everything queued; returns the number of requests processed
        (served or resolved to a structured error — flush itself only
        propagates programming errors, never faults).

        One admission per (fingerprint, flush) group — multiple tiles of the
        same matrix in one flush share the warm-pool entry they admitted.
        """
        if not self._queue:
            return 0
        queue, self._queue = self._queue, []
        with use_health(self.health):
            plan = _health.fault_plan()
            try:
                if plan is not None:
                    plan.fire("plan", None)
                tiles = plan_batches(queue, self.max_batch)
            except ValueError:
                raise  # max_batch < 1 is a configuration error, not a fault
            except Exception:
                # degraded planning: FIFO, one request per tile — no
                # coalescing, but every ticket still resolves
                self.stats.plan_failures += 1
                tiles = [Tile(r.fingerprint, (r,)) for r in queue]
            admitted: Dict[str, tuple] = {}
            failed: Dict[str, AdmissionError] = {}
            for tile in tiles:
                fp = tile.fingerprint
                if fp not in admitted and fp not in failed:
                    try:
                        admitted[fp] = self._admit_guarded(fp)
                    except AdmissionError as e:
                        failed[fp] = e
                if fp in failed:
                    self._fail_tile(tile, "admission", failed[fp],
                                    self.clock())
                    continue
                op, hit = admitted[fp]
                self._serve_tile(tile, op, hit)
        return len(queue)

    async def aflush(self) -> int:
        """``flush`` for asyncio front ends (execution itself is synchronous;
        the coroutine shape lets callers schedule it on a loop)."""
        return self.flush()

    # -- dynamic tenants ----------------------------------------------------

    def mutable(self, matrix_or_fingerprint: Union[str, Any]):
        """Open a mutation lane over one tenant's matrix: admits it (warm
        pool semantics identical to a flush-time admission) and returns a
        :class:`~repro_torch.core.dynamic.DeltaOverlay` whose base
        fingerprint is the engine's admission key, so :meth:`refresh` can
        re-admit the compacted matrix under its new identity.
        """
        from repro_torch.core.dynamic import DeltaOverlay

        if isinstance(matrix_or_fingerprint, str):
            fp = matrix_or_fingerprint
        else:
            fp = self.fingerprint(matrix_or_fingerprint)
            self._matrices.setdefault(fp, matrix_or_fingerprint)
        op, _hit = self._admit(fp)
        return DeltaOverlay(op, drift_threshold=self.drift_threshold,
                            fingerprint=fp)

    def refresh(self, overlay):
        """Compact a mutated tenant and re-admit it into the warm pool.

        Delegates to :meth:`DeltaOverlay.refresh` with the engine's
        ``drift_threshold`` and ``tune_mode`` (with ``tune_mode=None`` the
        refresh only compacts — selection is never re-run). When the matrix
        actually changed, the stale fingerprint is invalidated (not counted
        as a capacity eviction) and the compacted — possibly re-tuned —
        operator is inserted as the warmest entry under the new fingerprint;
        subsequent fingerprint-only submits must use
        ``result.fingerprint_after``.

        Returns the :class:`~repro_torch.core.dynamic.RefreshResult`; the
        ``refreshes`` / ``refresh_retunes`` / ``refresh_reselects`` counters
        land in :meth:`summary`.
        """
        old_fp = overlay.base_fingerprint
        res = overlay.refresh(threshold=self.drift_threshold,
                              mode=self.tune_mode)
        if res.compacted or res.retuned:
            if res.fingerprint_after != old_fp:
                self.workspace.discard(old_fp)
                self._matrices.pop(old_fp, None)
            self._matrices[res.fingerprint_after] = overlay.to_scipy()
            self.workspace.insert(res.fingerprint_after, res.operator)
        self.stats.record_refresh(retuned=res.retuned,
                                  reselected=res.reselected)
        return res

    # -- reporting ----------------------------------------------------------

    @property
    def wall_s(self) -> float:
        """First submit to last served result, on the engine's clock."""
        if self._t_first_submit is None:
            return 0.0
        return max(0.0, self._t_last_done - self._t_first_submit)

    def graph_stats(self) -> Dict:
        """The captured lanes: ``captures`` and ``replays`` this engine made,
        the captures' ``capture_s``, ``instantiate_s`` and ``nodes`` summed,
        and the ``live`` lanes its warm pool holds (an engine that shares a
        workspace shares its lanes)."""
        return dict(self._graphs, live=self.workspace.live_lanes())

    def summary(self) -> Dict:
        """``ServeStats.summary`` over the engine's own wall clock, plus the
        warm pool's LRU counters and the health registry's breaker state."""
        out = self.stats.summary(self.wall_s)
        out["workspace"] = self.workspace.stats()
        out["health"] = self.health.snapshot()
        return out
