"""Fault-tolerance primitives for the serving deployment, as
``repro.resilience.monitor`` (pure Python, a copy of the reference's):

- HeartbeatMonitor : per-worker liveness (stale heartbeat -> dead worker)
- StragglerMonitor : step-time outlier detection (p-median x factor)
- RestartPolicy    : bounded restarts with exponential backoff
- Supervisor       : wraps a step loop; on failure restores the latest
                     checkpoint + cursor and continues
- serve_under_supervision : the Supervisor wired to a *real* ServeEngine —
                     each step submits and flushes one batch of requests,
                     failed steps restore to the last completed batch

Every component takes an injectable ``clock`` (and, where it sleeps, a
``sleep_fn``) — the same pattern as ``ServeEngine`` — so the restart path
(restore/resume/replay) executes for real in tests without wall-clock
dependence. Defaults are ``time.monotonic`` / ``time.sleep`` for production.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class HeartbeatMonitor:
    """Per-worker liveness: a worker whose last beat is older than
    ``timeout_s`` on the monitor's clock is dead.

    ``now`` overrides remain for callers that timestamp externally; the
    injectable ``clock`` covers everyone else (tests pass a fake)."""

    def __init__(self, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last: Dict[str, float] = {}

    def beat(self, worker: str, now: Optional[float] = None):
        self.last[worker] = self.clock() if now is None else now

    def dead_workers(self, now: Optional[float] = None) -> List[str]:
        now = self.clock() if now is None else now
        return [w for w, t in self.last.items() if now - t > self.timeout_s]

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_workers(now)


def _median(sorted_vals: Sequence[float]) -> float:
    """True median: mean of the two middle elements for even lengths (the
    old ``sorted(...)[n // 2]`` upper-median inflated the straggler
    threshold by up to the inter-element gap on even windows)."""
    n = len(sorted_vals)
    mid = n // 2
    if n % 2:
        return sorted_vals[mid]
    return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])


class StragglerMonitor:
    """Flags steps slower than `factor` x rolling median — the launcher reacts
    by evicting/reassigning the slow host (here: recorded + surfaced)."""

    def __init__(self, window: int = 50, factor: float = 2.0):
        self.times = deque(maxlen=window)
        self.factor = factor
        self.flagged: List[int] = []
        self._step = 0

    def record(self, step_time_s: float) -> bool:
        self._step += 1
        is_straggler = False
        if len(self.times) >= 5:
            med = _median(sorted(self.times))
            is_straggler = step_time_s > self.factor * med
            if is_straggler:
                self.flagged.append(self._step)
        self.times.append(step_time_s)
        return is_straggler

    @property
    def median(self) -> Optional[float]:
        if not self.times:
            return None
        return _median(sorted(self.times))


@dataclass
class RestartPolicy:
    """Bounded restarts with exponential backoff, on an injectable clock.

    ``on_failure()`` returns ``'restart'`` while at most ``max_restarts``
    failures landed inside the sliding ``window_s``, else ``'abort'``. The
    backoff delay (``backoff_base_s * 2**(k-1)`` for the k-th recent
    failure) is recorded in ``last_delay_s`` / ``next_allowed_at`` and only
    *slept* when a ``sleep_fn`` is configured — the serving engine passes
    ``sleep_fn=None`` and enforces ``next_allowed_at`` on its own clock, so
    deterministic tests never block."""

    max_restarts: int = 3
    window_s: float = 3600.0
    backoff_base_s: float = 0.0     # 0 in tests; minutes in production
    history: List[float] = field(default_factory=list)
    clock: Callable[[], float] = time.monotonic
    sleep_fn: Optional[Callable[[float], None]] = time.sleep
    last_delay_s: float = 0.0
    next_allowed_at: float = 0.0

    def on_failure(self, now: Optional[float] = None) -> str:
        """-> 'restart' | 'abort'."""
        now = self.clock() if now is None else now
        self.history = [t for t in self.history if now - t < self.window_s]
        self.history.append(now)
        if len(self.history) > self.max_restarts:
            return "abort"
        delay = (self.backoff_base_s * 2 ** (len(self.history) - 1)
                 if self.backoff_base_s else 0.0)
        self.last_delay_s = delay
        self.next_allowed_at = now + delay
        if delay and self.sleep_fn is not None:
            self.sleep_fn(delay)
        return "restart"

    def reset(self) -> None:
        """Forget the failure history (a success closes the incident)."""
        self.history.clear()
        self.last_delay_s = 0.0
        self.next_allowed_at = 0.0


class Supervisor:
    """Run a step function with checkpoint/restart fault tolerance.

    step_fn(state, step_idx) -> state        (raises on failure)
    save_fn(state, step_idx) / restore_fn() -> (state, step_idx)

    ``clock`` feeds the straggler monitor's step timing (injectable, like
    everything in this module). An exception of a type in ``fatal`` is no
    step failure (a train step that cannot be captured fails the same way
    after any restore): it propagates at once, with nothing restored.
    """

    def __init__(self, step_fn: Callable, save_fn: Callable, restore_fn: Callable,
                 policy: Optional[RestartPolicy] = None,
                 checkpoint_every: int = 50,
                 straggler: Optional[StragglerMonitor] = None,
                 clock: Callable[[], float] = time.monotonic,
                 fatal: Tuple[type, ...] = ()):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.policy = policy or RestartPolicy()
        self.checkpoint_every = checkpoint_every
        self.straggler = straggler or StragglerMonitor()
        self.clock = clock
        self.fatal = fatal
        self.restarts = 0

    def run(self, state, start_step: int, n_steps: int):
        step = start_step
        while step < n_steps:
            try:
                t0 = self.clock()
                state = self.step_fn(state, step)
                self.straggler.record(self.clock() - t0)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.save_fn(state, step)
            except self.fatal:
                raise
            except Exception:
                action = self.policy.on_failure()
                if action == "abort":
                    raise
                self.restarts += 1
                state, step = self.restore_fn()
        return state, step


def serve_under_supervision(engine, batches: Sequence[Sequence[Tuple]],
                            policy: Optional[RestartPolicy] = None,
                            clock: Callable[[], float] = time.monotonic):
    """Drive a real :class:`~repro_torch.serve.engine.ServeEngine` under the
    Supervisor: the step function submits one batch of ``(matrix, rhs)``
    requests and flushes, and a failed step (a ticket resolving to a
    ``ServeError``, or anything else the engine lets propagate) restores to
    the last *completed* batch and replays from there with fresh submits.

    Args:
        engine: the serving engine (its own clock/health stay in charge of
            quarantine and retry *inside* a flush; the Supervisor guards the
            step loop *around* flushes).
        batches: ``batches[i]`` is the list of ``(matrix, rhs)`` pairs step
            ``i`` submits.
        policy / clock: Supervisor knobs (see :class:`RestartPolicy`).

    Returns:
        ``(results, supervisor)`` — ``results[i]`` is the list of served
        arrays for batch ``i``; ``supervisor.restarts`` counts replays.
    """
    saved = {"state": [], "step": 0}

    def step_fn(state, i):
        tickets = [engine.submit(m, r) for m, r in batches[i]]
        engine.flush()
        return state + [[t.result() for t in tickets]]  # raises on ServeError

    def save_fn(state, i):
        saved["state"] = list(state)
        saved["step"] = i

    def restore_fn():
        return list(saved["state"]), saved["step"]

    sup = Supervisor(step_fn, save_fn, restore_fn, policy=policy,
                     checkpoint_every=1, clock=clock)
    state, _ = sup.run([], 0, len(batches))
    return state, sup
