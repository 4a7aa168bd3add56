"""Per-``DispatchKey`` kernel health — the circuit breaker under dispatch.

Morpheus' portability argument rests on the fallback chain always holding a
correct implementation; this module makes the chain *health-aware* so it is
consulted not only for capability (``supports`` predicates) but for observed
behaviour. Dispatch reports every kernel outcome here; a key that fails
``failure_threshold`` consecutive times (or emits non-finite output
``nonfinite_threshold`` times under ``check_finite``) is **quarantined** and
healthy chain entries are preferred over it. The breaker is time-based
half-open: while the cooldown runs the key is ``blocked`` and never executes;
after the cooldown the next dispatch may try it once (the *probe*) — success
recovers the key, failure re-quarantines it and restarts the cooldown.

State machine (docs/resilience.md renders it)::

    healthy --k consecutive failures--> quarantined (blocked for cooldown_s)
    quarantined --cooldown elapsed--> probe-eligible (ordered last, may run)
    probe success --> healthy (recovery recorded)
    probe failure --> quarantined again (cooldown restarts)

Everything is clock-injectable (same pattern as ``ServeEngine``), so tests
and the chaos bench drive quarantine/recovery on a fake clock.

The module also owns the **fault-plan slot**: an active fault plan (an
object with ``fire(site, key)`` and ``corrupt(kind, key, y)``, as the
reference's resilience lane defines it) is stored here so dispatch pays
exactly one module-attribute read when none is armed;
``repro_torch.resilience.FaultPlan`` arms it.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# -------------------------------------------------------- fault-plan slot ----

# Set by a fault plan's __enter__ / __exit__; None in production. Instrumented sites read this (or call fault_plan()) and do
# nothing when it is None — that is the "zero overhead when inactive"
# contract the chaos bench's parity gate asserts.
_FAULT_PLAN = None


def fault_plan():
    """The active fault plan, or ``None``."""
    return _FAULT_PLAN


def _set_fault_plan(plan) -> None:
    global _FAULT_PLAN
    _FAULT_PLAN = plan


# ------------------------------------------------------------- key health ----


@dataclass
class KeyHealth:
    """Mutable per-key counters (one per ``DispatchKey`` the registry saw)."""

    failures: int = 0            # consecutive kernel raises
    nonfinite: int = 0           # consecutive non-finite outputs
    total_failures: int = 0
    total_nonfinite: int = 0
    successes: int = 0
    quarantined_at: Optional[float] = None  # None = not quarantined
    quarantine_started: Optional[float] = None  # first entry of this outage
    quarantines: int = 0
    probes: int = 0
    recoveries: int = 0
    last_recovery_s: Optional[float] = None  # outage duration of last recovery


class HealthRegistry:
    """Consecutive-failure tracking + time-based half-open circuit breaker.

    Args:
        failure_threshold: consecutive kernel raises that quarantine a key.
        nonfinite_threshold: consecutive non-finite outputs (under
            ``check_finite``) that quarantine a key — default 1: silent
            corruption is worse than a crash.
        cooldown_s: quarantine duration on the registry's clock; after it
            elapses the key becomes probe-eligible.
        clock: injectable monotonic clock (tests pass a fake).

    Example:
        >>> from repro_torch.core.spmv import DispatchKey
        >>> t = [0.0]
        >>> reg = HealthRegistry(failure_threshold=2, cooldown_s=10.0,
        ...                      clock=lambda: t[0])
        >>> k = DispatchKey("ell", "cuda")
        >>> reg.record_failure(k); reg.record_failure(k)
        >>> reg.blocked(k)                      # quarantined, cooldown runs
        True
        >>> t[0] = 11.0
        >>> reg.blocked(k)                      # cooldown over: probe allowed
        False
        >>> reg.record_success(k)               # probe succeeded
        >>> reg.quarantined(k), reg.snapshot()["recoveries"]
        (False, 1)
    """

    def __init__(self, *, failure_threshold: int = 2,
                 nonfinite_threshold: int = 1,
                 cooldown_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.nonfinite_threshold = int(nonfinite_threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._state: Dict[object, KeyHealth] = {}
        self.events: List[Tuple[str, str, float]] = []  # (event, key, t)

    # -- feeding (dispatch calls these) -------------------------------------

    def _get(self, key) -> KeyHealth:
        h = self._state.get(key)
        if h is None:
            h = self._state[key] = KeyHealth()
        return h

    def _log(self, event: str, key, t: float) -> None:
        self.events.append((event, f"{key.format}/{key.backend}", t))

    def _quarantine(self, h: KeyHealth, key, now: float, requarantine: bool) -> None:
        h.quarantined_at = now
        if h.quarantine_started is None:
            h.quarantine_started = now
        h.quarantines += 1
        self._log("requarantine" if requarantine else "quarantine", key, now)

    def record_failure(self, key) -> None:
        """A kernel under ``key`` raised."""
        h = self._get(key)
        h.failures += 1
        h.total_failures += 1
        now = self.clock()
        if h.quarantined_at is not None:
            # only a probe can execute while quarantined: a failure here is a
            # failed probe — re-quarantine and restart the cooldown
            h.probes += 1
            self._log("probe", key, now)
            self._quarantine(h, key, now, requarantine=True)
        elif h.failures >= self.failure_threshold:
            self._quarantine(h, key, now, requarantine=False)

    def record_nonfinite(self, key) -> None:
        """A kernel under ``key`` produced non-finite output (check_finite)."""
        h = self._get(key)
        h.nonfinite += 1
        h.total_nonfinite += 1
        now = self.clock()
        if h.quarantined_at is not None:
            h.probes += 1
            self._log("probe", key, now)
            self._quarantine(h, key, now, requarantine=True)
        elif h.nonfinite >= self.nonfinite_threshold:
            self._quarantine(h, key, now, requarantine=False)

    def record_success(self, key) -> None:
        """A kernel under ``key`` returned a (finite, if checked) result."""
        if not self._state:
            return  # hot path: nothing ever failed, nothing to update
        h = self._state.get(key)
        if h is None:
            return
        h.successes += 1
        if h.quarantined_at is not None:
            # the success of a probe: recover
            now = self.clock()
            h.probes += 1
            h.recoveries += 1
            if h.quarantine_started is not None:
                h.last_recovery_s = now - h.quarantine_started
            h.quarantined_at = None
            h.quarantine_started = None
            self._log("probe", key, now)
            self._log("recover", key, now)
        h.failures = 0
        h.nonfinite = 0

    # -- consulting (dispatch + serving read these) -------------------------

    def quarantined(self, key) -> bool:
        """Quarantined regardless of cooldown state."""
        h = self._state.get(key)
        return h is not None and h.quarantined_at is not None

    def blocked(self, key) -> bool:
        """Quarantined AND the cooldown has not elapsed: dispatch must not
        execute this key. After the cooldown, ``blocked`` is False while
        ``quarantined`` stays True — that window is the probe."""
        if not self._state:
            return False
        h = self._state.get(key)
        if h is None or h.quarantined_at is None:
            return False
        return (self.clock() - h.quarantined_at) < self.cooldown_s

    def any_quarantined(self) -> bool:
        if not self._state:
            return False
        return any(h.quarantined_at is not None for h in self._state.values())

    def quarantined_keys(self) -> List[object]:
        return [k for k, h in self._state.items() if h.quarantined_at is not None]

    def order(self, items: List, key_of: Callable = lambda e: e.key) -> List:
        """Stable health ordering: blocked keys go last, everything else
        keeps chain order. No-op (and allocation-free) while healthy."""
        if not self._state or not self.any_quarantined():
            return items
        healthy = [e for e in items if not self.blocked(key_of(e))]
        blocked = [e for e in items if self.blocked(key_of(e))]
        return healthy + blocked

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> Dict:
        """Aggregate counters + per-key detail for ``engine.summary()`` and
        ``BENCH_chaos.json``."""
        per_key = {}
        for k, h in self._state.items():
            per_key[f"{k.format}/{k.backend}"] = {
                "failures": h.total_failures,
                "nonfinite": h.total_nonfinite,
                "successes": h.successes,
                "quarantines": h.quarantines,
                "probes": h.probes,
                "recoveries": h.recoveries,
                "quarantined": h.quarantined_at is not None,
                "last_recovery_s": h.last_recovery_s,
            }
        recov = [h.last_recovery_s for h in self._state.values()
                 if h.last_recovery_s is not None]
        return {
            "quarantines": sum(h.quarantines for h in self._state.values()),
            "probes": sum(h.probes for h in self._state.values()),
            "recoveries": sum(h.recoveries for h in self._state.values()),
            "quarantined_now": sorted(f"{k.format}/{k.backend}"
                                      for k in self.quarantined_keys()),
            "max_recovery_s": max(recov) if recov else 0.0,
            "keys": per_key,
        }

    def reset(self) -> None:
        self._state.clear()
        self.events.clear()


# ---------------------------------------------------------- ambient scope ----

_DEFAULT = HealthRegistry()
_STACK: List[HealthRegistry] = []


def registry() -> HealthRegistry:
    """The ambient registry: innermost ``use_health`` scope, else the
    process-wide default (which real failures feed even outside serving)."""
    return _STACK[-1] if _STACK else _DEFAULT


@contextlib.contextmanager
def use_health(reg: HealthRegistry):
    """Scope the ambient health registry (the engine wraps each flush in its
    own registry so tenants sharing a process do not share quarantines
    unless they share an engine)."""
    _STACK.append(reg)
    try:
        yield reg
    finally:
        _STACK.pop()
