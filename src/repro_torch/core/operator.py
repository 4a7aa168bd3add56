"""`SparseOperator` + `ExecutionPolicy` — the Morpheus-style abstraction layer.

The PyTorch counterpart of ``repro.core.operator``:

  - ``SparseOperator``  : an immutable facade over any registered container.
    ``A @ x`` does SpMV, ``A @ X`` does SpMM, ``A.asformat("dia")`` is a
    cached runtime format switch, ``A.tune()`` runs the run-first
    auto-tuner (``mode="predict"``: the zero-run selector) and returns a
    retargeted operator.
  - ``ExecutionPolicy`` : a frozen description of *how* to execute — a
    backend preference chain plus the device-fit limits the ``cuda``
    kernels' ``supports(A, policy)`` predicates read.
  - ``use_policy`` / ``use_backend`` : context managers scoping the ambient
    policy.

The policy has the reference's fields except the TPU byte budget: the
choice between resident and column-tiled kernels is the column limit
``max_resident_cols`` alone (see ``core.tiling``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from . import tiling
from .convert import col_tile_for_policy, convert, from_dense
from .formats import registered_formats, torch_dtype

# ----------------------------------------------------------------- policy ----


@dataclass(frozen=True)
class ExecutionPolicy:
    """How to execute sparse ops: backend preference chain + device limits.

    ``backends`` is tried in order; a backend is skipped when no kernel is
    registered for the operand's format or its ``supports`` predicate rejects
    the (matrix, policy) pair.

    - ``max_resident_cols``: matrices with at most this many columns run the
      resident kernels, larger ones the column-tiled kernels over the
      container's convert-time :class:`~repro_torch.core.formats.KernelPlan`.
    - ``index_dtype``: dtype of tile-local column indices inside kernel
      plans (``"auto"`` compresses to the narrowest that fits).
    - ``value_dtype``: storage dtype of the matrix values.
    - ``accum_dtype``: only ``"float32"`` is implemented.
    - ``check_finite``: validate operands at the operator boundary and count
      a non-finite kernel output as a failure inside dispatch.

    Example:
        >>> p = ExecutionPolicy(index_dtype="int16", value_dtype="bfloat16")
        >>> p.index_dtype, p.torch_value_dtype()
        ('int16', torch.bfloat16)
    """

    backends: Tuple[str, ...] = ("plain",)
    max_resident_cols: int = tiling.DEFAULT_MAX_RESIDENT_COLS
    max_onehot_rows: int = 8192        # COO full-window row limit
    allow_fallback: bool = True        # walk down the chain on unsupported
    index_dtype: str = "auto"          # "auto" | "int8" | "int16" | "int32"
    value_dtype: str = "float32"       # "float32" | "bfloat16" | "float16" | "float64"
    accum_dtype: str = "float32"       # only "float32" is implemented
    check_finite: bool = False

    def replace(self, **kw) -> "ExecutionPolicy":
        return dataclasses.replace(self, **kw)

    def torch_value_dtype(self) -> torch.dtype:
        """The ``value_dtype`` knob as a torch dtype."""
        return torch_dtype(self.value_dtype)

    def storage_kw(self, fmt: str) -> dict:
        """Converter kwargs realising this policy's storage dtypes for
        ``fmt`` — ``dtype`` for every format, plus ``index_dtype`` for the
        formats whose kernel plans carry per-entry column indices."""
        kw = {"dtype": self.torch_value_dtype()}
        if fmt in ("coo", "csr", "ell", "sell"):
            kw["index_dtype"] = self.index_dtype
        return kw

    def resident_cols(self) -> int:
        """Columns of x a resident kernel may take under this policy."""
        return tiling.resident_cols(self.max_resident_cols)

    def col_tile(self, ncols: int) -> Optional[int]:
        """Column-tile width the tiled kernels should use for ``ncols``, or
        ``None`` when x fits resident under this policy."""
        return tiling.select_col_tile(ncols, self.max_resident_cols)

    def preferring(self, impl: str) -> "ExecutionPolicy":
        """This policy retargeted to prefer ``impl``, falling back to plain
        (the reference's chain shape; on a CUDA device a ``cuda`` kernel that
        raises is not replaced by plain, see ``core.spmv``)."""
        chain = (impl,) if impl == "plain" else (impl, "plain")
        return self.replace(backends=chain)

    @classmethod
    def for_impl(cls, impl: str, **kw) -> "ExecutionPolicy":
        return cls(**kw).preferring(impl)


DEFAULT_POLICY = ExecutionPolicy()


def policy_for_impl(impl: str) -> ExecutionPolicy:
    return ExecutionPolicy.for_impl(impl)


class _PolicyStack(threading.local):
    def __init__(self):
        self.stack = []


_POLICY = _PolicyStack()


def current_policy() -> ExecutionPolicy:
    """The ambient policy (innermost ``use_policy`` scope, or the default)."""
    return _POLICY.stack[-1] if _POLICY.stack else DEFAULT_POLICY


@contextlib.contextmanager
def use_policy(policy: Optional[ExecutionPolicy] = None, **kw):
    """Scope the ambient ExecutionPolicy: ``use_policy(pol)`` pushes
    ``pol``; ``use_policy(backends=("cuda",))`` derives from the current
    ambient policy."""
    base = policy if policy is not None else current_policy()
    if kw:
        base = base.replace(**kw)
    _POLICY.stack.append(base)
    try:
        yield base
    finally:
        _POLICY.stack.pop()


def use_backend(*backends: str, fallback: bool = True):
    """``use_backend("cuda")`` == prefer the CUDA kernels, fall back to
    plain where they do not apply (and, for host tensors, where they raise).
    ``fallback=False`` is strict: plain is not appended and the preferred
    backend must run."""
    chain = tuple(backends)
    if fallback and "plain" not in chain:
        chain += ("plain",)
    return use_policy(backends=chain, allow_fallback=fallback)


# --------------------------------------------------------------- operator ----


@dataclass(frozen=True)
class SparseOperator:
    """Format-agnostic linear operator over a registered sparse container.

    ``container`` holds the tensors, ``policy`` decides which kernel runs,
    ``_cache`` memoises format conversions across an ``asformat`` chain.

    Example:
        >>> import numpy as np, scipy.sparse as sp
        >>> A = as_operator(sp.eye(4, format="csr") * 2.0, device="cpu")
        >>> A.format, A.shape, A.nnz
        ('csr', (4, 4), 4)
        >>> [float(v) for v in A @ np.ones(4, np.float32)]
        [2.0, 2.0, 2.0, 2.0]
    """

    container: Any
    policy: Optional[ExecutionPolicy] = None
    _cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    # -- introspection ------------------------------------------------------

    @property
    def format(self) -> str:
        return self.container.format

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.container.shape)

    @property
    def dtype(self):
        return self.container.dtype

    @property
    def device(self) -> torch.device:
        return self.container.device

    @property
    def nnz(self) -> int:
        return self.container.nnz

    @property
    def nbytes(self) -> int:
        """Device bytes of the container (data + index arrays + any plan)."""
        return sum(t.numel() * t.element_size() for t in self.container.tensors())

    @property
    def bytes_per_nnz(self) -> float:
        return self.nbytes / max(1, self.nnz)

    def __repr__(self):
        pol = "" if self.policy is None else f", backends={self.policy.backends}"
        return (f"SparseOperator(format={self.format!r}, shape={self.shape}, "
                f"nnz={self.nnz}{pol})")

    # -- policy retargeting -------------------------------------------------

    def with_policy(self, policy: Optional[ExecutionPolicy]) -> "SparseOperator":
        return SparseOperator(self.container, policy, self._cache)

    def using(self, *backends: str, fallback: bool = True, **kw) -> "SparseOperator":
        """Operator preferring ``backends`` (chain ends in plain by default).
        ``fallback=False`` is strict, like ``use_backend``."""
        chain = tuple(backends)
        if fallback and "plain" not in chain:
            chain += ("plain",)
        base = self.policy if self.policy is not None else DEFAULT_POLICY
        opts = {"backends": chain, "allow_fallback": fallback, **kw}
        return self.with_policy(base.replace(**opts))

    def _effective_policy(self) -> ExecutionPolicy:
        return self.policy if self.policy is not None else current_policy()

    # -- format switching ---------------------------------------------------

    def asformat(self, fmt: str, **kw) -> "SparseOperator":
        """Switch storage format at runtime; the result shares this
        operator's policy and conversion cache and stays on its device."""
        if fmt == self.format and not kw:
            return self
        if fmt not in registered_formats():
            raise ValueError(f"unknown format {fmt!r}; registered: {registered_formats()}")
        key = (fmt, tuple(sorted(kw.items())))
        if key not in self._cache:
            self._cache[key] = convert(self.container, fmt, **kw)
        return SparseOperator(self._cache[key], self.policy, self._cache)

    def to_dense(self) -> torch.Tensor:
        return self.container.to_dense()

    # -- application --------------------------------------------------------

    def _operand(self, v) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device)

    def __matmul__(self, other):
        from .spmv import _dispatch_spmm, _dispatch_spmv

        other = self._operand(other)
        if other.ndim not in (1, 2):
            raise ValueError(f"SparseOperator @ ndim={other.ndim}: expected 1 (SpMV) or 2 (SpMM)")
        if other.shape[0] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ {tuple(other.shape)}")
        pol = self._effective_policy()
        if pol.check_finite:
            from .errors import validate_container, validate_rhs

            validate_rhs(other, context=f"rhs of {self.format} @")
            validate_container(self.container)
        if other.ndim == 1:
            return _dispatch_spmv(self.container, other, pol)
        return _dispatch_spmm(self.container, other, pol)

    def matvec(self, x) -> torch.Tensor:
        return self @ x

    def matmat(self, X) -> torch.Tensor:
        return self @ X

    def batched_matvec(self, xs) -> torch.Tensor:
        """``(k, ncols)`` stack of right-hand sides -> ``(k, nrows)``; row
        ``i`` equals ``self @ xs[i]`` on the SpMV-per-column SpMM lane."""
        xs = self._operand(xs)
        if xs.ndim != 2:
            raise ValueError(f"batched_matvec: xs must be (k, ncols), got ndim={xs.ndim}")
        if xs.shape[1] != self.shape[1]:
            raise ValueError(f"batched_matvec: {self.shape} against rhs stack "
                             f"{tuple(xs.shape)} (columns must match)")
        return (self @ xs.T).T

    def masked_matvec(self, x, row_mask) -> torch.Tensor:
        """Row-masked SpMV: ``where(row_mask, A @ x, 0)`` — one color of a
        multicolor Gauss-Seidel sweep, through the dispatch table."""
        from .spmv import _dispatch_masked_spmv

        mask = torch.as_tensor(row_mask, dtype=torch.bool, device=self.device)
        return _dispatch_masked_spmv(self.container, self._operand(x), mask,
                                     self._effective_policy())

    # -- dynamic matrices ---------------------------------------------------

    def mutable(self, drift_threshold: Optional[float] = None,
                fingerprint: Optional[str] = None):
        """Open a mutation lane over this operator: a
        :class:`~repro_torch.core.dynamic.DeltaOverlay` buffering inserts,
        updates and deletes as a COO delta while ``A @ x`` stays exact
        (``base @ x + delta @ x``). :meth:`refresh` (or the overlay's own
        ``refresh()``) compacts and, only when structural drift crosses the
        threshold, re-runs zero-run selection.

        Args:
            drift_threshold: refresh trigger (default
                ``dynamic.DEFAULT_DRIFT_THRESHOLD``).
            fingerprint: warm-pool fingerprint to associate with this base
                (the serving layer passes its admission key so overlay and
                pool agree on identity).

        Example:
            >>> import numpy as np, scipy.sparse as sp
            >>> ov = as_operator(sp.eye(4, format="csr") * 2.0, device="cpu").mutable()
            >>> ov.set(0, 3, 1.0)
            >>> [float(v) for v in ov @ np.ones(4, np.float32)]
            [3.0, 2.0, 2.0, 2.0]
        """
        from .dynamic import DEFAULT_DRIFT_THRESHOLD, DeltaOverlay

        thr = (DEFAULT_DRIFT_THRESHOLD if drift_threshold is None
               else drift_threshold)
        return DeltaOverlay(self, drift_threshold=thr, fingerprint=fingerprint)

    def refresh(self, overlay, threshold: Optional[float] = None,
                mode: str = "predict", **kw) -> "SparseOperator":
        """Compact ``overlay`` (opened on this operator via :meth:`mutable`)
        and re-select the (format, backend) only when drift crossed the
        threshold. Returns the up-to-date operator; the full decision record
        is ``overlay.refresh(...)`` directly (a
        :class:`~repro_torch.core.dynamic.RefreshResult`).
        """
        if overlay.base.container is not self.container:
            raise ValueError("refresh: overlay was not opened on this "
                             "operator (its base has moved on — refresh via "
                             "the overlay itself, or re-open with .mutable())")
        return overlay.refresh(threshold=threshold, mode=mode, **kw).operator

    # -- auto-tuning --------------------------------------------------------

    def tune(self, candidates=None, mode: str = "run", **kw) -> "SparseOperator":
        """Pick a (format, backend) and return the retargeted operator (same
        device, same policy limits).

        ``mode="run"`` races the candidates with the run-first auto-tuner
        (``kw`` goes to ``autotune_spmv``). ``mode="predict"`` runs no
        kernel: the zero-run selector (``core/select.py``) ranks the
        candidates from the matrix's features and this operator's policy on
        the cost table of its device (``kw`` goes to ``select.predict``),
        and only the host-side conversion to the predicted format happens.
        A predicted ``cuda`` key leads the returned chain; on the card its
        predicate must accept the converted container, so dispatch never
        gives way to plain.
        """
        if mode == "predict":
            return self._predicted(candidates, **kw)
        if mode != "run":
            raise ValueError(f"tune mode {mode!r}: expected 'run' or 'predict'")
        from .autotune import autotune_spmv

        kw.setdefault("device", self.device)
        return autotune_spmv(self, candidates=candidates,
                             policy=self.policy, **kw).operator


    def _predicted(self, candidates=None, **kw) -> "SparseOperator":
        from . import select
        from .errors import BackendUnsupportedError
        from .spmv import dispatch_table

        base = self.policy if self.policy is not None else DEFAULT_POLICY
        kw.setdefault("platform", self.device.type)
        pred = select.predict(self.container, policy=base, candidates=candidates, **kw)
        fmt, backend = pred.key
        tuned = self
        if fmt in ("coo", "csr", "dia", "ell", "sell"):
            ncols = int(self.shape[1])
            want = col_tile_for_policy(fmt, ncols, base.col_tile(ncols))
            want_ct = int(want) if want not in (False, 0) else None
            cur = getattr(self.container, "plan", None)
            cur_ct = int(cur.ct) if fmt == self.format and cur is not None else None
            # rebuild on a format change, or when the plan's tile geometry
            # does not match this policy: a stale plan would make dispatch
            # reject the predicted backend
            if fmt != self.format or cur_ct != want_ct:
                tuned = self.asformat(fmt, col_tile=want)
        elif fmt != self.format:
            tuned = self.asformat(fmt)
        policy = base.preferring(backend)
        entry = dispatch_table("spmv").get(pred.key)
        if (backend == "cuda" and self.device.type == "cuda"
                and not entry.ok(tuned.container, policy)):
            raise BackendUnsupportedError(
                f"predicted {fmt}/cuda rejects the converted {fmt} container of shape "
                f"{self.shape} under {policy}")
        return tuned.with_policy(policy)


def as_operator(a, fmt: Optional[str] = None, policy: Optional[ExecutionPolicy] = None,
                device="cuda", **kw) -> SparseOperator:
    """Wrap anything matrix-like into a SparseOperator.

    Args:
        a: a ``SparseOperator`` (retargeted to ``fmt``/``policy`` if given),
            a registered container, a scipy sparse matrix, or a dense array.
        fmt: target format for scipy/dense inputs (default ``"csr"``), or a
            conversion request for operator/container inputs.
        policy: optional ``ExecutionPolicy`` to attach; its column limit and
            storage dtypes shape a build from scipy/dense input.
        device: where a build from scipy/dense input goes (default
            ``"cuda"``; raises without a card). Operators and containers
            keep their own device.
        **kw: forwarded to the format conversion.
    """
    import numpy as np
    import scipy.sparse as sp

    if isinstance(a, SparseOperator):
        if fmt is not None:
            a = a.asformat(fmt, **kw)
        return a.with_policy(policy) if policy is not None else a
    if getattr(type(a), "format", None) in registered_formats() and not sp.issparse(a):
        op = SparseOperator(a, policy)
        return op.asformat(fmt, **kw) if fmt is not None else op
    if sp.issparse(a) or isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "__array__"):
        tgt = fmt or "csr"
        shape = getattr(a, "shape", None)
        if (policy is not None and "col_tile" not in kw
                and tgt in ("coo", "csr", "dia", "ell", "sell")
                and shape is not None and len(shape) == 2):
            ncols = int(shape[1])
            kw = {**kw, "col_tile": col_tile_for_policy(
                tgt, ncols, policy.col_tile(ncols))}
        if policy is not None:
            kw = {**policy.storage_kw(tgt), **kw}
        return SparseOperator(from_dense(a, tgt, device=device, **kw), policy)
    raise TypeError(f"cannot build a SparseOperator from {type(a).__name__}")
