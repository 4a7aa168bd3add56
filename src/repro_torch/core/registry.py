"""Handle/workspace cache: the operator warm pool, as ``repro.core.registry``.

Morpheus hides ArmPL's ``create -> hint -> optimize -> exec*N -> destroy``
behind a per-format workspace that re-uses the handle across SpMV calls on
the same matrix. This module caches the *converted operator* keyed by a
cheap structural fingerprint, so repeated ``spmv_cached`` calls on the same
logical matrix pay conversion once. The cache is a true LRU: hits move the
entry to the back, so the hottest matrices are evicted last.

The workspace doubles as the serving layer's **warm pool**
(``repro_torch.serve.ServeEngine``): :meth:`SpmvWorkspace.admit` is the
fingerprint-keyed admission path, capacity evicts the least-recently served
tenant, and :meth:`SpmvWorkspace.stats` exposes the hit/miss/eviction
counters the serving stats report.

Beside each entry the pool keeps the serving engine's captured lanes
(:meth:`SpmvWorkspace.lanes`, ``repro_torch.serve.lanes.CapturedLane``):
where the reference's ``jax.jit`` cache keys a compiled lane on the
operator's structure, a CUDA graph holds the entry's addresses, so its
graphs live and die with the entry (LRU eviction, ``discard``, an
``insert`` that replaces it). :meth:`SpmvWorkspace.spmv` is the reference's
``get_fn``, a ``jax.jit(lambda A, x: spmv(A, x, policy=policy))`` for each
(format, policy): on a CUDA device it replays an ``mv`` lane captured for
the requested policy and the rhs dtype, kept beside the entry in the same
dict; on the host, and for a rhs that is not one vector or a policy that
checks for non-finite output (a host read, as the engine's tiles run it),
it calls dispatch eagerly.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .formats import registered_formats
from .operator import ExecutionPolicy, SparseOperator, as_operator, policy_for_impl
from .spmv import spmv


def _host_bytes(t: torch.Tensor) -> bytes:
    """The bytes numpy would give for ``t`` (bf16 as its bit pattern, which
    is what an ml_dtypes bf16 array holds)."""
    t = t.detach().cpu()
    if t.dtype is torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


class SpmvWorkspace:
    """Singleton-per-process workspace (paper Table I machinery)."""

    def __init__(self, max_entries: int = 64):
        if max_entries < 0:
            raise ValueError(
                f"SpmvWorkspace: max_entries must be >= 0, got {max_entries} "
                f"(0 means cache nothing — every admission builds and is "
                f"immediately evicted)")
        self._ops: "OrderedDict[str, SparseOperator]" = OrderedDict()
        self._lanes: Dict[str, dict] = {}  # fingerprint -> its captured lanes
        self._max = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def capacity(self) -> int:
        return self._max

    def stats(self) -> dict:
        """Cache counters: ``hits``/``misses`` (every keyed lookup),
        ``evictions`` (capacity pops), current ``size`` and ``capacity``."""
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "size": len(self._ops), "capacity": self._max}

    def _evict_to(self, room: int) -> None:
        while len(self._ops) > max(0, self._max - room):
            fp, _ = self._ops.popitem(last=False)  # least-recently-used first
            self._drop_lanes(fp)
            self.evictions += 1

    def _drop_lanes(self, fingerprint: str) -> None:
        lanes = self._lanes.pop(fingerprint, None)
        if lanes:
            lanes.clear()  # a caller still holding the dict holds no graph

    def lanes(self, fingerprint: str, op: SparseOperator) -> dict:
        """The captured lanes kept beside the entry ``fingerprint`` while it
        holds ``op`` (keyed by the caller); a fresh dict the pool does not
        keep when ``op`` is not the entry (evicted, replaced, never held)."""
        if self._ops.get(fingerprint) is not op:
            return {}
        return self._lanes.setdefault(fingerprint, {})

    def live_lanes(self) -> int:
        """Captured lanes held beside the pool's entries."""
        return sum(len(v) for v in self._lanes.values())

    @staticmethod
    def fingerprint(a) -> str:
        """SHA-1 over a subsample of the matrix: the reference's digest byte
        for byte for scipy and dense input; a container hashes its tensors
        in the reference's pytree leaf order (fields, then the plan's
        arrays), each subsampled on its device before the copy to the host.
        Caches (``A.cache``, ``plan.cache``) are never hashed."""
        import scipy.sparse as sp

        if isinstance(a, SparseOperator):
            a = a.container
        h = hashlib.sha1()
        if sp.issparse(a):
            s = a.tocsr()
            h.update(np.int64(s.shape[0]).tobytes() + np.int64(s.shape[1]).tobytes())
            h.update(np.asarray(s.indptr[:: max(1, len(s.indptr) // 64)]).tobytes())
            # indices must participate: two matrices with identical row
            # lengths and values but different column positions are
            # different operators (same stride as the other leaves)
            h.update(np.asarray(s.indices[:: max(1, len(s.indices) // 64)]).tobytes())
            h.update(np.asarray(s.data[:: max(1, len(s.data) // 64)]).tobytes())
            return h.hexdigest()
        if getattr(type(a), "format", None) in registered_formats():
            h.update(repr((a.format, tuple(a.shape))).encode())
            for leaf in a.tensors():
                flat = leaf.reshape(-1)
                h.update(_host_bytes(flat[:: max(1, flat.numel() // 64)]))
            return h.hexdigest()
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(repr(tuple(a.shape)).encode())  # same bytes, different shape
        h.update(a.tobytes())
        return h.hexdigest()

    def get_operator(self, a, fmt: str, device="cuda", **kw) -> SparseOperator:
        """LRU-cached conversion handle for (matrix fingerprint, format);
        a build from scipy/dense input goes to ``device``."""
        return self._operator(self._key(a, fmt, kw), a, fmt, device, kw)

    def _key(self, a, fmt: str, kw: dict) -> str:
        return f"{self.fingerprint(a)}:{fmt}:{sorted(kw.items())}"

    def _operator(self, key: str, a, fmt: str, device, kw: dict) -> SparseOperator:
        if key in self._ops:
            self.hits += 1
            self._ops.move_to_end(key)  # true LRU: a hit refreshes recency
            return self._ops[key]
        self.misses += 1
        op = as_operator(a, fmt, device=device, **kw)
        self.insert(key, op)  # evicts after insert: size never exceeds capacity
        return op

    def lookup(self, fingerprint: str) -> Optional[SparseOperator]:
        """Warm-pool probe by raw fingerprint: a hit refreshes recency and
        counts; a miss counts and returns ``None`` (no build)."""
        if fingerprint in self._ops:
            self.hits += 1
            self._ops.move_to_end(fingerprint)
            return self._ops[fingerprint]
        self.misses += 1
        return None

    def admit(self, fingerprint: str,
              build: Callable[[], SparseOperator]) -> Tuple[SparseOperator, bool]:
        """Fingerprint-keyed admission (the serving layer's warm pool).

        Returns ``(operator, hit)``. On a miss, ``build()`` constructs the
        operator (typically ``as_operator(...).tune(mode="predict")``) and
        the result is inserted, evicting the LRU entry on capacity. The
        eviction runs *after* the insert: any ``get_operator`` / ``lookup``
        hit the build performs refreshes that entry's recency first, and
        ``size`` never exceeds ``capacity`` — at ``max_entries=0`` the
        fresh entry itself is evicted immediately (built, returned, not
        retained).
        """
        if fingerprint in self._ops:
            self.hits += 1
            self._ops.move_to_end(fingerprint)
            return self._ops[fingerprint], True
        self.misses += 1
        op = build()
        self.insert(fingerprint, op)
        return op, False

    def insert(self, fingerprint: str, op: SparseOperator) -> None:
        """Place ``op`` at ``fingerprint`` as the most-recent entry, then
        evict down to capacity — no hit/miss counters (the serving layer's
        re-admission path after a drift-driven refresh). Replacing an entry
        drops its captured lanes."""
        if self._ops.get(fingerprint, op) is not op:
            self._drop_lanes(fingerprint)
        self._ops[fingerprint] = op
        self._ops.move_to_end(fingerprint)
        self._evict_to(0)

    def discard(self, fingerprint: str) -> bool:
        """Drop ``fingerprint`` if present (not counted as an eviction: the
        entry is invalidated — e.g. its matrix mutated — not capacity-popped).
        Returns whether it was present. Its captured lanes go with it."""
        self._drop_lanes(fingerprint)
        return self._ops.pop(fingerprint, None) is not None

    def get_matrix(self, a, fmt: str, **kw):
        return self.get_operator(a, fmt, **kw).container

    def spmv(self, a, x, fmt: str = "csr", impl: Optional[str] = None,
             policy: Optional[ExecutionPolicy] = None, device="cuda", **kw):
        """``A @ x`` through the cached operator of ``(a, fmt)``: on a CUDA
        device the replay of the entry's captured ``mv`` lane for ``policy``
        (a fresh tensor each call), else dispatch's eager call."""
        if policy is None:
            policy = policy_for_impl(impl or "plain")
        key = self._key(a, fmt, kw)
        op = self._operator(key, a, fmt, device, kw)
        x = torch.as_tensor(x, device=op.device)
        if (op.device.type != "cuda" or policy.check_finite
                or tuple(x.shape) != (op.shape[1],)):
            return spmv(op.container, x, policy=policy)
        from repro_torch.serve.lanes import CapturedLane

        lanes = self.lanes(key, op)
        lane = lanes.get(("spmv", x.dtype, policy))
        if lane is None:
            lane = CapturedLane(op.with_policy(policy), "mv", 1, x.dtype)
            lanes[("spmv", x.dtype, policy)] = lane
        return lane([x])

    def __len__(self) -> int:
        return len(self._ops)

    def keys(self):
        return tuple(self._ops)


_WORKSPACE: Optional[SpmvWorkspace] = None


def workspace() -> SpmvWorkspace:
    global _WORKSPACE
    if _WORKSPACE is None:
        _WORKSPACE = SpmvWorkspace()
    return _WORKSPACE


def spmv_cached(a, x, fmt: str = "csr", impl: Optional[str] = None,
                policy: Optional[ExecutionPolicy] = None, device="cuda", **kw):
    return workspace().spmv(a, x, fmt, impl, policy=policy, device=device, **kw)
