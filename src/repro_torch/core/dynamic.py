"""Dynamic sparse matrices: the COO-delta mutation lane + drift-driven
refresh, as ``repro.core.dynamic``.

Every container is immutable and a structure change is a full host-side
rebuild, but the format decision must be revisitable at runtime as sparsity
evolves (Stylianou & Weiland, "Exploiting dynamic sparse matrices",
PAPERS.md). This module adds that lane on top of the zero-run selector
(``core/select.py``) and the fingerprint-keyed warm pool
(``core/registry.py``).

Three pieces:

  - :class:`DeltaOverlay` — a mutable COO delta buffered over an immutable
    base :class:`~repro_torch.core.operator.SparseOperator`. ``insert`` /
    ``update`` / ``delete`` / ``add`` are host-side buffer writes; ``A @ x``
    stays exact with the two-kernel sum ``base @ x + delta @ x`` until
    compaction (the delta is itself a COO container on the base's device,
    so the tuned base kernel keeps running untouched).
  - **drift detection** — cheap feature deltas (nnz, row-imbalance, ndiags,
    band extent) tracked *incrementally* per mutation and compared against
    the features captured at the base fingerprint: no merge, no extraction
    pass, no kernel dispatch.
  - :meth:`DeltaOverlay.refresh` — compacts the overlay (fold the delta into
    the base container, bit-identically to a from-scratch rebuild) and
    re-runs ``tune(mode="predict")`` **only** when drift crosses a
    configurable threshold. A base format that drifted into structural
    infeasibility (e.g. inserts pushed ``ndiags`` past the DIA guard) forces
    re-selection regardless of the scalar threshold.

The delta's COO is built without a column-tile plan, as the reference
builds it: past ``max_onehot_rows`` rows its ``cuda`` predicate rejects it
and the delta runs on ``coo/plain`` on the base's device.

The host mirror, the counters and the drift are numpy/scipy and equal the
reference's exactly. The serving layer re-admits a refreshed fingerprint
into the warm pool (``repro_torch.serve.ServeEngine.refresh``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from .features import MatrixFeatures, extract_features, _to_entries
from .operator import SparseOperator, as_operator

#: Relative feature drift at which :meth:`DeltaOverlay.refresh` re-selects.
#: 0.25 ≈ "a quarter of the structure moved": well above FDM coefficient
#: jitter (which changes values, not structure) yet crossed by a few percent
#: of band-widening inserts or a pruning sweep.
DEFAULT_DRIFT_THRESHOLD = 0.25


def _rel(now: float, then: float) -> float:
    """Relative change of a tracked feature against its base snapshot."""
    return abs(float(now) - float(then)) / max(abs(float(then)), 1.0)


@dataclass(frozen=True)
class DriftReport:
    """Per-feature relative drift of an overlay against its base snapshot.

    Each component is ``|now - base| / max(|base|, 1)`` over a feature the
    overlay tracks incrementally; ``score`` (the refresh trigger) is their
    max, so any single structural axis running away is enough. ``infeasible``
    carries the reason the *base format* no longer passes the structural
    guards (``select.infeasible``) — a forced-refresh signal independent of
    the scalar score.
    """

    nnz: float
    rownnz_imbalance: float
    ndiags: float
    band_extent: float
    infeasible: Optional[str] = None

    @property
    def score(self) -> float:
        return max(self.nnz, self.rownnz_imbalance, self.ndiags,
                   self.band_extent)

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        d["score"] = self.score
        return d

    def __repr__(self):
        return (f"DriftReport(score={self.score:.3f}, nnz={self.nnz:.3f}, "
                f"imb={self.rownnz_imbalance:.3f}, ndiags={self.ndiags:.3f}, "
                f"band={self.band_extent:.3f}"
                + (f", infeasible={self.infeasible!r}" if self.infeasible else "")
                + ")")


@dataclass(frozen=True)
class RefreshResult:
    """What one :meth:`DeltaOverlay.refresh` call did."""

    operator: SparseOperator        # the up-to-date (compacted, maybe retuned) base
    drift: DriftReport              # drift measured before compaction
    compacted: bool                 # a non-empty delta was folded in
    retuned: bool                   # tune() re-ran (threshold crossed / forced)
    key_before: Tuple[str, str]     # (format, preferred backend) pre-refresh
    key_after: Tuple[str, str]
    fingerprint_before: str
    fingerprint_after: str

    @property
    def reselected(self) -> bool:
        """Did the refresh actually change the (format, backend) choice?"""
        return self.key_after != self.key_before


class DeltaOverlay:
    """A mutable COO-delta overlay over an immutable base operator.

    The base operator (any registered format, any policy) keeps serving
    ``A @ x`` through its tuned kernel; mutations land in a host-side buffer
    of ``(row, col) -> new value`` overrides. The overlay's matvec is the
    exact two-kernel sum ``base @ x + delta @ x`` where the delta container
    holds *value differences* (``new - base``), so results match the mutated
    matrix in exact arithmetic without ever rebuilding the base.

    Mutations also update incremental feature counters (per-row nnz, per-
    diagonal occupancy), which makes :meth:`drift` a pure dictionary lookup —
    the cheap decision procedure runtime format switching needs.

    A scipy or dense ``base`` is built on ``device`` (default ``"cuda"``);
    an operator or container keeps its own.

    Example:
        >>> import scipy.sparse as sp
        >>> import numpy as np
        >>> ov = DeltaOverlay(sp.eye(4, format="csr") * 2.0, device="cpu")
        >>> ov.set(0, 3, 1.0)           # insert
        >>> ov.delete(1, 1)             # structural delete
        >>> x = np.ones(4, np.float32)
        >>> [float(v) for v in ov @ x]  # base @ x + delta @ x
        [3.0, 0.0, 2.0, 2.0]
        >>> ov.nnz, ov.ndelta
        (4, 2)
    """

    def __init__(self, base, drift_threshold: float = DEFAULT_DRIFT_THRESHOLD,
                 fingerprint: Optional[str] = None, device="cuda"):
        base = as_operator(base, device=device)
        self.drift_threshold = float(drift_threshold)
        self._delta: Dict[Tuple[int, int], float] = {}
        self._delta_op: Optional[SparseOperator] = None
        self._rebase(base, fingerprint=fingerprint)

    # -- base bookkeeping ----------------------------------------------------

    def _mirror(self, op: SparseOperator) -> sp.csr_matrix:
        """Canonical host-side scipy mirror of the base's *logical* entries
        (padding undone per format, explicit zeros dropped, indices sorted)
        — built without densifying, via the feature extractor's entry walk."""
        row, col, val, shape = _to_entries(op.container)
        s = sp.csr_matrix((np.asarray(val, np.float64),
                           (np.asarray(row), np.asarray(col))), shape=shape)
        s.sum_duplicates()
        s.eliminate_zeros()
        s.sort_indices()
        return s

    def _rebase(self, op: SparseOperator, s: Optional[sp.csr_matrix] = None,
                fingerprint: Optional[str] = None) -> None:
        from .registry import SpmvWorkspace

        self.base = op
        self._base_s = self._mirror(op) if s is None else s
        self.base_features = extract_features(self._base_s)
        self.base_fingerprint = (fingerprint if fingerprint is not None
                                 else SpmvWorkspace.fingerprint(self._base_s))
        # incremental feature counters (logical nonzeros)
        nrows = int(self._base_s.shape[0])
        self._rowcounts = np.diff(self._base_s.indptr).astype(np.int64)
        coo = self._base_s.tocoo()
        offs, cnts = np.unique(coo.col.astype(np.int64)
                               - coo.row.astype(np.int64), return_counts=True)
        self._diagcounts: Dict[int, int] = dict(
            zip((int(o) for o in offs), (int(c) for c in cnts)))
        self._nnz = int(self._base_s.nnz)
        self._delta.clear()
        self._delta_op = None
        # the drift baseline is the structure the *selection decision* saw —
        # it survives compaction (else periodic refresh would keep resetting
        # drift to ~0 and the threshold would never trip) and only moves when
        # a re-tune actually re-decides (or at construction)
        if getattr(self, "decision_features", None) is None:
            self.decision_features = self.base_features

    def _retarget(self, op: SparseOperator) -> None:
        """Swap the base operator for a retuned twin of the *same* logical
        matrix (mirror, counters and fingerprint stay valid); the selection
        just re-decided, so the drift baseline moves here."""
        self.base = op
        self.decision_features = self.base_features

    # -- introspection -------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(int(d) for d in self._base_s.shape)

    @property
    def format(self) -> str:
        return self.base.format

    @property
    def nnz(self) -> int:
        """Logical nonzeros of the mutated matrix (base + delta applied)."""
        return self._nnz

    @property
    def ndelta(self) -> int:
        """Buffered mutations (coordinates whose value differs from base)."""
        return len(self._delta)

    def value(self, i: int, j: int) -> float:
        """Current logical value at ``(i, j)`` — delta first, then base."""
        self._check(i, j)
        try:
            return self._delta[(i, j)]
        except KeyError:
            return float(self._base_s[i, j])

    def features(self) -> MatrixFeatures:
        """Features of the mutated matrix from the incremental counters —
        exact for every field except ``block_density``/``block_density32``
        and ``dense_cols`` (not tracked per-mutation; carried over from the
        base snapshot)."""
        f0 = self.base_features
        nrows, ncols = self.shape
        if self._nnz == 0:
            return MatrixFeatures(nrows, ncols, 0, 0.0, 0.0, 0.0, 0.0, 0, 0,
                                  0.0, 0, 0.0, 0)
        counts = self._rowcounts.astype(np.float64)
        ndiags = len(self._diagcounts)
        return MatrixFeatures(
            nrows=nrows, ncols=ncols, nnz=self._nnz,
            density=self._nnz / float(max(nrows * ncols, 1)),
            rownnz_mean=float(counts.mean()),
            rownnz_std=float(counts.std()),
            rownnz_var=float(counts.var()),
            rownnz_max=int(counts.max()),
            ndiags=ndiags,
            diag_fill=self._nnz / float(max(ndiags * nrows, 1)),
            band_extent=self._band_extent(),
            block_density=f0.block_density,
            dense_cols=f0.dense_cols,
            block_density32=f0.block_density32,
        )

    def _band_extent(self) -> int:
        return max((abs(o) for o in self._diagcounts), default=0)

    def __repr__(self):
        return (f"DeltaOverlay(base={self.base!r}, ndelta={self.ndelta}, "
                f"nnz={self.nnz})")

    # -- mutation ------------------------------------------------------------

    def _check(self, i: int, j: int) -> None:
        nrows, ncols = self.shape
        if not (0 <= i < nrows and 0 <= j < ncols):
            raise IndexError(f"entry ({i}, {j}) outside {self.shape}")

    def set(self, i: int, j: int, v: float) -> None:
        """Set entry ``(i, j)`` to ``v`` (insert when absent, update when
        present; ``v == 0`` is a structural delete)."""
        self._check(i, j)
        i, j, v = int(i), int(j), float(v)
        old = self._delta.get((i, j))
        base_v = float(self._base_s[i, j])
        if old is None:
            old = base_v
        if old == 0.0 and v != 0.0:          # logical insert
            self._nnz += 1
            self._rowcounts[i] += 1
            self._diagcounts[j - i] = self._diagcounts.get(j - i, 0) + 1
        elif old != 0.0 and v == 0.0:        # logical delete
            self._nnz -= 1
            self._rowcounts[i] -= 1
            d = j - i
            self._diagcounts[d] -= 1
            if self._diagcounts[d] == 0:
                del self._diagcounts[d]
        if v == base_v:                       # mutation reverted exactly
            self._delta.pop((i, j), None)
        else:
            self._delta[(i, j)] = v
        self._delta_op = None

    #: ``insert`` / ``update`` are intent-named aliases of :meth:`set` —
    #: the overlay resolves present/absent itself.
    insert = set
    update = set

    def delete(self, i: int, j: int) -> None:
        """Structurally delete entry ``(i, j)`` (a no-op if already zero)."""
        self.set(i, j, 0.0)

    def add(self, i: int, j: int, dv: float) -> None:
        """Increment entry ``(i, j)`` by ``dv`` — FDM-assembly style."""
        self.set(i, j, self.value(i, j) + float(dv))

    def set_many(self, rows, cols, vals) -> None:
        """Batch :meth:`set` over parallel coordinate/value arrays."""
        rows, cols, vals = (np.asarray(a) for a in (rows, cols, vals))
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError(f"set_many: mismatched shapes "
                             f"{rows.shape}/{cols.shape}/{vals.shape}")
        for i, j, v in zip(rows.tolist(), cols.tolist(), vals.tolist()):
            self.set(i, j, v)

    # -- application ---------------------------------------------------------

    def delta_operator(self) -> Optional[SparseOperator]:
        """The buffered mutations as a COO operator of value *differences*
        (``new - base``), or ``None`` when clean. Cached until the next
        mutation; plans are disabled (the delta is small by construction)."""
        if not self._delta:
            return None
        if self._delta_op is None:
            items = list(self._delta.items())
            rows = np.fromiter((i for (i, _), _ in items), np.int64,
                               count=len(items))
            cols = np.fromiter((j for (_, j), _ in items), np.int64,
                               count=len(items))
            new = np.fromiter((v for _, v in items), np.float64,
                              count=len(items))
            base = np.asarray(
                self._base_s[rows, cols]).reshape(-1).astype(np.float64)
            d = sp.coo_matrix((new - base, (rows, cols)), shape=self.shape)
            self._delta_op = as_operator(d, "coo", policy=self.base.policy,
                                         device=self.base.device, col_tile=False)
        return self._delta_op

    def matvec(self, x):
        """Exact mutated-matrix SpMV: ``base @ x + delta @ x``."""
        x = self.base._operand(x)  # one copy to the device for both terms
        y = self.base @ x
        d = self.delta_operator()
        return y if d is None else y + (d @ x)

    def matmat(self, X):
        """Exact mutated-matrix SpMM, same two-kernel decomposition."""
        return self.matvec(X)

    def __matmul__(self, other):
        return self.matvec(other)

    # -- drift ---------------------------------------------------------------

    def drift(self) -> DriftReport:
        """Relative feature drift against the last *selection decision*
        (``decision_features``), from the incremental counters alone — no
        merge, no extraction pass, no kernel dispatch. Compaction does not
        reset it; only a refresh that re-tunes does."""
        from . import select

        f0 = self.decision_features
        nrows = max(self.shape[0], 1)
        mean = self._nnz / nrows
        rmax = int(self._rowcounts.max()) if self._rowcounts.size else 0
        imb = rmax / max(mean, 1.0)
        return DriftReport(
            nnz=_rel(self._nnz, f0.nnz),
            rownnz_imbalance=_rel(imb, f0.rownnz_imbalance),
            ndiags=_rel(len(self._diagcounts), f0.ndiags),
            band_extent=_rel(self._band_extent(), f0.band_extent),
            infeasible=select.infeasible(self.features(), self.base.format),
        )

    def drifted(self, threshold: Optional[float] = None) -> bool:
        """Has drift crossed ``threshold`` (default: the overlay's own)?"""
        thr = self.drift_threshold if threshold is None else threshold
        rep = self.drift()
        return rep.score >= thr or rep.infeasible is not None

    # -- compaction / refresh ------------------------------------------------

    def to_scipy(self) -> sp.csr_matrix:
        """The mutated matrix merged into one canonical scipy CSR (sorted
        indices, no explicit zeros) — exactly what a from-scratch rebuild
        would start from, which is what makes :meth:`compact` bit-identical
        to rebuilding."""
        if not self._delta:
            return self._base_s.copy()
        ncols = self.shape[1]
        items = list(self._delta.items())
        drows = np.fromiter((i for (i, _), _ in items), np.int64,
                            count=len(items))
        dcols = np.fromiter((j for (_, j), _ in items), np.int64,
                            count=len(items))
        dvals = np.fromiter((v for _, v in items), np.float64,
                            count=len(items))
        base = self._base_s.tocoo()
        base_keys = base.row.astype(np.int64) * ncols + base.col.astype(np.int64)
        touched = ~np.isin(base_keys, drows * ncols + dcols)
        live = dvals != 0.0                    # deletes vanish at merge
        s = sp.csr_matrix(
            (np.concatenate([base.data[touched], dvals[live]]),
             (np.concatenate([base.row[touched], drows[live]]),
              np.concatenate([base.col[touched], dcols[live]]))),
            shape=self.shape)
        s.sum_duplicates()
        s.sort_indices()
        return s

    def compact(self) -> SparseOperator:
        """Fold the delta into the base container — same format, same
        policy, bit-identical to rebuilding the mutated matrix from scratch.
        Idempotent: with a clean delta the base is returned unchanged."""
        if not self._delta:
            return self.base
        s = self.to_scipy()
        kw = {"C": self.base.container.C} if self.base.format == "sell" else {}
        op = as_operator(s, self.base.format, policy=self.base.policy,
                         device=self.base.device, **kw)
        self._rebase(op, s)
        return op

    def refresh(self, threshold: Optional[float] = None,
                mode: Optional[str] = "predict", **kw) -> RefreshResult:
        """Compact, and re-select (``tune``) only when drift crossed
        ``threshold`` — the amortised runtime-format-switching step.

        Args:
            threshold: drift score at which re-selection runs (default: the
                overlay's ``drift_threshold``). A base format that drifted
                into structural infeasibility re-selects regardless.
            mode: forwarded to :meth:`SparseOperator.tune` — ``"predict"``
                (zero-run, the default) or ``"run"`` (measure). ``None``
                compacts only: selection is never re-run, not even on
                infeasibility (an untuned serving engine's refresh path).
            **kw: forwarded to ``tune``.

        Returns:
            A :class:`RefreshResult`; ``result.operator`` is the up-to-date
            base (also reachable as ``overlay.base``), and the overlay
            continues to buffer future mutations over it.
        """
        thr = self.drift_threshold if threshold is None else threshold
        report = self.drift()
        fp_before = self.base_fingerprint
        key_before = self._key(self.base)
        compacted = bool(self._delta)
        op = self.compact()
        retuned = False
        if mode is not None and (report.score >= thr
                                 or report.infeasible is not None):
            op = op.tune(mode=mode, **kw)
            self._retarget(op)
            retuned = True
        return RefreshResult(
            operator=op, drift=report, compacted=compacted, retuned=retuned,
            key_before=key_before, key_after=self._key(op),
            fingerprint_before=fp_before,
            fingerprint_after=self.base_fingerprint)

    @staticmethod
    def _key(op: SparseOperator) -> Tuple[str, str]:
        return (op.format, op._effective_policy().backends[0])
