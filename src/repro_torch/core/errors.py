"""The structured exception taxonomy + boundary validators.

The same classes as ``repro.core.errors``, so callers classify failures the
same way in both packages:

  - ``SparseInputError``     : the operands are unusable (NaN/Inf rhs,
                               malformed container indices). Not retryable.
  - ``KernelExecutionError`` : a dispatched kernel raised or produced
                               non-finite output; the chain may degrade.
  - ``AdmissionError``       : building/tuning an operator failed.
  - ``SolverDivergenceError``: CG's residual went non-finite.
  - ``BackendUnsupportedError``: fallback disabled and the preferred backend
                               cannot run.
  - ``InjectedFault``        : raised by a fault plan at an instrumented
                               site — deliberately not a ``ResilienceError``.

The validators implement ``ExecutionPolicy.check_finite``. PyTorch runs
eagerly, so every operand is concrete and every check applies.
"""
from __future__ import annotations

import torch


class ResilienceError(RuntimeError):
    """Base of the structured failure taxonomy."""


class BackendUnsupportedError(ResilienceError):
    """Raised when fallback is disabled and the preferred backend rejects."""


class SparseInputError(ResilienceError):
    """The operands are unusable: non-finite rhs or a malformed container."""


class KernelExecutionError(ResilienceError):
    """A dispatched kernel raised, or produced non-finite output under
    ``check_finite``; carries the original failure as ``__cause__``."""


class AdmissionError(ResilienceError):
    """Admission (build + tune) failed after bounded retries."""


class SolverDivergenceError(ResilienceError):
    """An iterative solve produced a non-finite residual or iterate."""


class InjectedFault(RuntimeError):
    """Raised by an active fault plan at an instrumented site; outside the
    ``ResilienceError`` hierarchy so it is never mistaken for a real one."""


# ------------------------------------------------------------- validators ----


def _all_finite(x) -> bool:
    """True when every element of ``x`` is finite (non-float: vacuously)."""
    x = torch.as_tensor(x)
    if not (x.is_floating_point() or x.is_complex()):
        return True
    return bool(torch.isfinite(x).all())


def validate_rhs(x, context: str = "rhs") -> None:
    """``check_finite`` input guard: reject a non-finite right-hand side.

    Raises:
        SparseInputError: when ``x`` contains NaN/Inf.
    """
    if not _all_finite(x):
        raise SparseInputError(
            f"{context} contains non-finite values "
            f"(shape {tuple(torch.as_tensor(x).shape)}); refusing to dispatch")


def validate_container(A) -> None:
    """``check_finite`` container guard: value arrays must be finite and
    index arrays in range (pad sentinels — ``-1`` entries, COO's ``nrows``
    row bucket — are allowed).

    Raises:
        SparseInputError: naming the offending field.
    """
    fmt = getattr(A, "format", "?")
    nrows, ncols = (int(s) for s in A.shape)

    def _bad(field, why):
        raise SparseInputError(
            f"malformed {fmt} container: {field} {why} "
            f"(shape {(nrows, ncols)})")

    for t in A.tensors():
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            _bad("values", "contain non-finite entries")
    if fmt in ("ell", "sell", "csr"):
        idx = A.indices
        if idx.numel() and (int(idx.min()) < -1 or int(idx.max()) >= ncols):
            _bad("indices", f"out of range [-1, {ncols})")
    elif fmt == "coo":
        row, col = A.row, A.col
        if row.numel() and (int(row.min()) < 0 or int(row.max()) > nrows):
            _bad("row", f"out of range [0, {nrows}]")
        if col.numel() and (int(col.min()) < 0 or int(col.max()) >= ncols):
            _bad("col", f"out of range [0, {ncols})")
