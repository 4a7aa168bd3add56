"""Seeded, deterministic fault injection for the resilience lane, as
``repro.resilience.faults``.

A :class:`FaultPlan` is a context manager that arms named failures at the
instrumented sites of the stack; while no plan is active every site is a
single ``None``-check.

Sites (the instrumentation lives where the failure would really originate):

    ==========  ===============================  ==============================
    site        instrumented in                  effect when triggered
    ==========  ===============================  ==============================
    kernel      ``core/spmv.py`` dispatch        kernel raises ``InjectedFault``
                                                 before executing
    nonfinite   ``core/spmv.py`` dispatch        kernel output replaced by NaN
    plan        ``serve/engine.py`` flush        batch planning raises
    admission   ``serve/engine.py`` admission    the warm-pool build raises
    halo        (no site in this package yet)    the exchanged halo window is
                                                 zeroed (a dropped message)
    ==========  ===============================  ==============================

Determinism: each :class:`FaultSpec` counts its *eligible events* (site +
key match) and fires on events ``start .. start+times-1`` — with the default
``p=1.0`` no randomness is consulted at all, and with ``p < 1`` draws come
from ``np.random.default_rng(seed + spec_index)``, so two runs over the same
call sequence inject identically. ``plan.events`` records every fired event
for assertions.

Example — kill the ELL CUDA lane for its next two dispatches::

    with FaultPlan([FaultSpec("kernel", key=("ell", "cuda"), times=2)]):
        engine.flush()          # the engine degrades, the breaker may quarantine

Injected failures raise :class:`~repro_torch.core.errors.InjectedFault`,
which is deliberately outside the ``ResilienceError`` taxonomy: recovery
paths treat it like any unexpected kernel failure, but nothing can
mis-classify it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import health as _health
from repro_torch.core.errors import InjectedFault

SITES = ("kernel", "nonfinite", "plan", "admission", "halo")


@dataclass(frozen=True)
class FaultSpec:
    """One armed failure: *what* to break, *when*, and *how often*.

    Args:
        site: one of :data:`SITES`.
        key: narrows which events match — ``None`` matches every event at
            the site; a ``(format, backend)`` tuple (or ``DispatchKey``)
            matches that dispatch cell exactly; a string matches a backend
            or format name (kernel sites) or a fingerprint prefix
            (admission sites).
        times: how many matching events to inject (0 disarms the spec).
        start: skip this many eligible events first (inject mid-traffic).
        p: per-event probability once past ``start`` (1.0 = deterministic).
    """

    site: str
    key: Union[None, str, Tuple[str, str], object] = None
    times: int = 1
    start: int = 0
    p: float = 1.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; know {SITES}")

    def matches(self, key) -> bool:
        if self.key is None:
            return True
        if key is None:
            return False
        # DispatchKey-shaped target: exact-cell tuple or name match
        fmt = getattr(key, "format", None)
        backend = getattr(key, "backend", None)
        if fmt is not None and backend is not None:
            if isinstance(self.key, str):
                return self.key in (fmt, backend)
            return tuple(self.key) == (fmt, backend)
        # string target (admission fingerprints)
        if isinstance(self.key, str) and isinstance(key, str):
            return key.startswith(self.key)
        return False


def _keystr(key) -> str:
    if key is None:
        return "*"
    # note: `getattr(key, "format", ...)` is a trap here — every str has a
    # bound .format method, so fingerprint strings must be handled first
    if isinstance(key, str):
        return key[:16]
    fmt = getattr(key, "format", None)
    backend = getattr(key, "backend", None)
    if fmt is not None and backend is not None:
        return f"{fmt}/{backend}"
    return str(key)[:16]


class FaultPlan:
    """Deterministic fault schedule, armed via ``with plan: ...``.

    While entered, the plan is installed in the core fault slot
    (``repro_torch.core.health``); the instrumented sites consult it through
    :meth:`fire` / :meth:`corrupt` / :meth:`drop`. Re-entrant use is an
    error (one plan at a time); the same plan object can be entered again
    after exit and continues its counters — build a fresh plan for a fresh
    schedule.
    """

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self.events: List[Tuple[str, str, int]] = []  # (site, key, event idx)
        self._seen = [0] * len(self.specs)    # eligible events per spec
        self._fired = [0] * len(self.specs)
        self._rngs = [np.random.default_rng(self.seed + i)
                      for i in range(len(self.specs))]

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "FaultPlan":
        if _health.fault_plan() is not None:
            raise RuntimeError("a FaultPlan is already active")
        _health._set_fault_plan(self)
        return self

    def __exit__(self, *exc) -> None:
        _health._set_fault_plan(None)

    @property
    def active(self) -> bool:
        return _health.fault_plan() is self

    # -- site hooks ---------------------------------------------------------

    def _trigger(self, site: str, key) -> bool:
        hit = False
        for i, spec in enumerate(self.specs):
            if spec.site != site or not spec.matches(key):
                continue
            idx = self._seen[i]
            self._seen[i] += 1
            if self._fired[i] >= spec.times or idx < spec.start:
                continue
            if spec.p < 1.0 and self._rngs[i].random() >= spec.p:
                continue
            self._fired[i] += 1
            hit = True
        if hit:
            self.events.append((site, _keystr(key), len(self.events)))
        return hit

    def fire(self, site: str, key=None) -> None:
        """Raise :class:`InjectedFault` when a spec triggers (kernel / plan /
        admission sites)."""
        if self._trigger(site, key):
            raise InjectedFault(f"injected {site} fault at {_keystr(key)}")

    def corrupt(self, site: str, key, y):
        """Replace ``y`` with NaNs when a spec triggers (nonfinite site)."""
        if self._trigger(site, key):
            return torch.full_like(y, float("nan"))
        return y

    def drop(self, site: str, key, x):
        """Zero ``x`` when a spec triggers (halo site: a dropped message)."""
        if self._trigger(site, key):
            return torch.zeros_like(x)
        return x

    # -- reporting ----------------------------------------------------------

    def fired(self, site: Optional[str] = None) -> int:
        """Events injected so far (optionally at one site)."""
        if site is None:
            return len(self.events)
        return sum(1 for s, _, _ in self.events if s == site)

    def __repr__(self):
        return (f"FaultPlan(specs={len(self.specs)}, seed={self.seed}, "
                f"fired={self.fired()}, active={self.active})")
