"""Structured SpMV/SpMM dispatch + the 'plain' (eager torch) implementations.

The dispatch table is keyed by ``DispatchKey(format, backend)`` as in
``repro.core.spmv``. Backends:

  - ``plain`` : straightforward torch transliterations of Algorithms 1-3
  - ``dense`` : densify + dense matmul
  - ``cuda``  : hand-written CUDA kernels, registered lazily by
                ``repro_torch.kernels.ops``

Each registration may carry a ``supports(A, policy)`` predicate; dispatch
walks the policy's backend chain, and a kernel that raises falls to the next
entry with the failure recorded in the ambient ``core.health`` registry —
the reference's semantics, kept for operands on the host. On a CUDA device
a ``cuda`` kernel that the chain selected runs or raises
``KernelExecutionError``: it is never skipped for, nor replaced by, a later
entry of the chain, quarantined or not. SpMM without a native kernel is a
loop of SpMV over the columns, so column ``j`` of ``A @ X`` equals
``A @ X[:, j]``.

The plain kernels reduce without float atomics: csr and coo sum each row's
products with ``torch.segment_reduce`` over the row pointer, sell with the
same over its lanes. On a CUDA device ``index_add_`` would add in an order
that changes from run to run, and HPCG's bitwise tier compares two runs.
What a plain kernel reads from the device (csr's logical nnz, coo's row
order, segment_reduce's check of its segments) it reads on its first call
for a container and keeps, so a warm solve reads nothing and can be
captured in a CUDA graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import health as _health
from .errors import BackendUnsupportedError, KernelExecutionError, _all_finite
from .formats import BSR, COO, CSR, DIA, ELL, SELL, Dense
from .operator import ExecutionPolicy, current_policy, policy_for_impl

# ------------------------------------------------------------- dispatch ----


@dataclass(frozen=True)
class DispatchKey:
    """One slot of the dispatch table: (container format, backend name)."""

    format: str
    backend: str

    def __iter__(self):  # allow `fmt, backend = key` unpacking
        return iter((self.format, self.backend))


@dataclass(frozen=True)
class KernelEntry:
    key: DispatchKey
    fn: Callable
    supports: Optional[Callable] = None  # (A, policy) -> bool; None = always
    needs_policy: bool = False  # fn takes the policy (multi-strategy kernels)

    def ok(self, A, policy: ExecutionPolicy) -> bool:
        return self.supports is None or bool(self.supports(A, policy))

    def call(self, A, *operands, policy: ExecutionPolicy):
        if self.needs_policy:
            return self.fn(A, *operands, policy)
        return self.fn(A, *operands)


_SPMV: Dict[DispatchKey, KernelEntry] = {}
_SPMM: Dict[DispatchKey, KernelEntry] = {}
_SPMV_MASKED: Dict[DispatchKey, KernelEntry] = {}


def register_spmv(fmt: str, backend: str, supports: Optional[Callable] = None,
                  needs_policy: bool = False):
    """Decorator registering an SpMV kernel under ``DispatchKey(fmt, backend)``.
    ``supports`` is the ``(A, policy) -> bool`` capability predicate;
    ``needs_policy`` passes the policy as a trailing argument."""
    def deco(fn):
        key = DispatchKey(fmt, backend)
        _SPMV[key] = KernelEntry(key, fn, supports, needs_policy)
        return fn
    return deco


def register_spmm(fmt: str, backend: str, supports: Optional[Callable] = None,
                  needs_policy: bool = False):
    """Decorator registering a *native* SpMM kernel ``fn(A, X) -> Y``."""
    def deco(fn):
        key = DispatchKey(fmt, backend)
        _SPMM[key] = KernelEntry(key, fn, supports, needs_policy)
        return fn
    return deco


def register_masked_spmv(fmt: str, backend: str, supports: Optional[Callable] = None,
                         needs_policy: bool = False):
    """Decorator registering a row-masked SpMV kernel
    ``fn(A, x, row_mask) -> y`` (``y == 0`` outside the mask)."""
    def deco(fn):
        key = DispatchKey(fmt, backend)
        _SPMV_MASKED[key] = KernelEntry(key, fn, supports, needs_policy)
        return fn
    return deco


def available_impls(fmt: str):
    """Backends with a registered SpMV kernel for ``fmt``."""
    _ensure_cuda()
    return tuple(sorted(k.backend for k in _SPMV if k.format == fmt))


def dispatch_table(op: str = "spmv") -> Dict[DispatchKey, KernelEntry]:
    """A snapshot of one dispatch table (``"spmv"`` | ``"spmm"`` |
    ``"masked_spmv"``)."""
    _ensure_cuda()
    return dict({"spmv": _SPMV, "spmm": _SPMM, "masked_spmv": _SPMV_MASKED}[op])


def _ensure_cuda():
    """Register the ``cuda`` backend (importing the module builds nothing:
    kernels compile at their first launch)."""
    from repro_torch.kernels import ops  # noqa: F401  registers (fmt, "cuda")


def _on_card(x) -> bool:
    """Operands (or a container) on a CUDA device: there a ``cuda`` kernel
    runs or raises."""
    return x.device.type == "cuda"


def _holds_cuda(items, key_of=lambda e: e.key) -> bool:
    return any(key_of(e).backend == "cuda" for e in items)


def _order(items: List, on_card: bool, key_of: Callable = lambda e: e.key) -> List:
    """Health ordering of a chain; on the card a chain that holds a ``cuda``
    entry keeps its order, so a quarantined kernel is never passed over."""
    if on_card and _holds_cuda(items, key_of):
        return items
    return _health.registry().order(items, key_of=key_of)


def _spmv_chain(A, policy: ExecutionPolicy, on_card: bool = False) -> List[KernelEntry]:
    """Every registered + supporting entry along the policy's backend chain,
    healthy entries first (on the card, see ``_order``). With
    ``allow_fallback=False`` only the preferred backend is considered and a
    rejecting predicate raises."""
    if "cuda" in policy.backends:
        _ensure_cuda()
    tried: List[str] = []
    cands: List[KernelEntry] = []
    for backend in policy.backends:
        entry = _SPMV.get(DispatchKey(A.format, backend))
        if entry is not None and entry.ok(A, policy):
            if not policy.allow_fallback:
                return [entry]
            cands.append(entry)
            continue
        why = "unregistered" if entry is None else "unsupported"
        if not policy.allow_fallback:
            raise BackendUnsupportedError(
                f"backend {backend!r} {why} for {A.format} matrix of shape "
                f"{tuple(A.shape)} under {policy} and fallback is disabled")
        tried.append(f"{backend}: {why}")
    if not cands:
        raise KeyError(
            f"no SpMV for format {A.format!r} under backend chain {policy.backends}; "
            f"tried [{'; '.join(tried)}]; registered: {sorted((k.format, k.backend) for k in _SPMV)}")
    return _order(cands, on_card)


def select_spmv(A, policy: ExecutionPolicy) -> KernelEntry:
    """The entry dispatch would run first for ``A`` under ``policy``: on a
    container on the card, as ``_dispatch_spmv`` orders it there, a chain
    that holds ``cuda`` keeps its order however the keys' health stands."""
    return _spmv_chain(A, policy, _on_card(A))[0]


def _run_chain(steps: List[Tuple[DispatchKey, Callable]],
               policy: ExecutionPolicy, opname: str, on_card: bool = False):
    """Execute the first step that completes; a step that raises (or returns
    non-finite output under ``check_finite``) records a failure against its
    key and control falls to the next step. The failure of the last step,
    or of a ``cuda`` step on the card, is wrapped in
    ``KernelExecutionError``."""
    reg = _health.registry()
    plan = _health._FAULT_PLAN
    last_exc: Optional[Exception] = None
    for i, (key, thunk) in enumerate(steps):
        final = ((i == len(steps) - 1) or not policy.allow_fallback
                 or (on_card and key.backend == "cuda"))
        try:
            if plan is not None:
                plan.fire("kernel", key)
            y = thunk()
            if plan is not None:
                y = plan.corrupt("nonfinite", key, y)
        except Exception as e:
            reg.record_failure(key)
            if final:
                raise KernelExecutionError(
                    f"{opname} kernel {key.format}x{key.backend} failed with "
                    f"{type(e).__name__}: {e} (chain {policy.backends}; on a "
                    f"CUDA device a cuda kernel does not fall back)") from e
            last_exc = e
            continue
        if policy.check_finite and not _all_finite(y):
            reg.record_nonfinite(key)
            err = KernelExecutionError(
                f"{opname} kernel {key.format}x{key.backend} produced "
                f"non-finite output (policy.check_finite)")
            if final:
                raise err
            last_exc = err
            continue
        reg.record_success(key)
        return y
    raise last_exc  # pragma: no cover — loop always returns or raises


def _dispatch_spmv(A, x, policy: ExecutionPolicy) -> torch.Tensor:
    on_card = _on_card(x)
    steps = [(e.key, (lambda e=e: e.call(A, x, policy=policy)))
             for e in _spmv_chain(A, policy, on_card)]
    return _run_chain(steps, policy, "SpMV", on_card)


def _dispatch_spmm(A, X, policy: ExecutionPolicy) -> torch.Tensor:
    """SpMM: a native kernel when one is registered along the chain, else
    SpMV per column. A native kernel that raises, is quarantined, or emits
    non-finite output degrades to the per-column lane — except a ``cuda``
    kernel on the card, which runs or raises."""
    if "cuda" in policy.backends:
        _ensure_cuda()
    reg = _health.registry()
    plan = _health._FAULT_PLAN
    on_card = _on_card(X)
    for backend in policy.backends:
        strict = not policy.allow_fallback or (on_card and backend == "cuda")
        entry = _SPMM.get(DispatchKey(A.format, backend))
        if entry is None:
            if not policy.allow_fallback:
                break
            continue
        if not entry.ok(A, policy):
            if not policy.allow_fallback:
                raise BackendUnsupportedError(
                    f"SpMM backend {backend!r} rejected {A.format} matrix of shape "
                    f"{tuple(A.shape)} under {policy} and fallback is disabled")
            continue
        if not strict and reg.blocked(entry.key):
            continue
        try:
            if plan is not None:
                plan.fire("kernel", entry.key)
            Y = entry.call(A, X, policy=policy)
            if plan is not None:
                Y = plan.corrupt("nonfinite", entry.key, Y)
        except Exception as e:
            reg.record_failure(entry.key)
            if strict:
                raise KernelExecutionError(
                    f"SpMM kernel {entry.key.format}x{entry.key.backend} failed "
                    f"with {type(e).__name__} and may not fall back") from e
            break
        if policy.check_finite and not _all_finite(Y):
            reg.record_nonfinite(entry.key)
            if strict:
                raise KernelExecutionError(
                    f"SpMM kernel {entry.key.format}x{entry.key.backend} produced "
                    f"non-finite output (policy.check_finite)")
            break
        reg.record_success(entry.key)
        return Y
    Xt = X.t().contiguous()  # each column one contiguous vector, as the kernels take x
    cols = [_dispatch_spmv(A, Xt[j], policy) for j in range(X.shape[1])]
    if not cols:
        return torch.zeros((A.shape[0], 0), dtype=X.dtype, device=X.device)
    return torch.stack(cols, dim=1)


def _dispatch_masked_spmv(A, x, row_mask, policy: ExecutionPolicy) -> torch.Tensor:
    """y = mask ⊙ (A @ x): the color-sweep primitive of multicolor SymGS.
    A native masked kernel wins; otherwise the same backend's unmasked
    kernel runs and the mask is applied after."""
    if "cuda" in policy.backends:
        _ensure_cuda()
    tried: List[str] = []
    steps: List[Tuple[DispatchKey, Callable]] = []
    for backend in policy.backends:
        key = DispatchKey(A.format, backend)
        entry = _SPMV_MASKED.get(key)
        if entry is not None and entry.ok(A, policy):
            steps.append((key, (lambda entry=entry:
                                entry.call(A, x, row_mask, policy=policy))))
            if not policy.allow_fallback:
                break
            continue
        base = _SPMV.get(key)
        if base is not None and base.ok(A, policy):
            steps.append((key, (lambda base=base:
                                _mask_rows(base.call(A, x, policy=policy), row_mask))))
            if not policy.allow_fallback:
                break
            continue
        why = "unregistered" if (entry is None and base is None) else "unsupported"
        if not policy.allow_fallback:
            raise BackendUnsupportedError(
                f"masked SpMV backend {backend!r} {why} for {A.format} matrix of "
                f"shape {tuple(A.shape)} under {policy} and fallback is disabled")
        tried.append(f"{backend}: {why}")
    if not steps:
        raise KeyError(
            f"no masked SpMV for format {A.format!r} under chain {policy.backends}; "
            f"tried [{'; '.join(tried)}]")
    on_card = _on_card(x)
    steps = _order(steps, on_card, key_of=lambda s: s[0])
    return _run_chain(steps, policy, "masked SpMV", on_card)


def _mask_rows(y: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(row_mask, y, torch.zeros((), dtype=y.dtype, device=y.device))


def masked_spmv(A, x, row_mask, impl: Optional[str] = None, *,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Row-masked SpMV: ``where(row_mask, A @ x, 0)`` through the table."""
    A = _unwrap(A)
    return _dispatch_masked_spmv(A, x, row_mask, _shim_policy(A, impl, policy, _SPMV))


# ------------------------------------------------------ back-compat shims ----


def _unwrap(A):
    from .operator import SparseOperator

    return A.container if isinstance(A, SparseOperator) else A


def _shim_policy(A, impl: Optional[str], policy: Optional[ExecutionPolicy],
                 table: Dict[DispatchKey, KernelEntry]) -> ExecutionPolicy:
    if policy is not None:
        return policy
    if impl is None:
        return current_policy()
    if impl == "cuda":
        _ensure_cuda()
    key = DispatchKey(A.format, impl)
    if key not in table and key not in _SPMV:
        raise KeyError(f"no kernel registered for {(A.format, impl)}; "
                       f"have {sorted((k.format, k.backend) for k in _SPMV)}")
    return policy_for_impl(impl)


def spmv(A, x, impl: Optional[str] = None, *,
         policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Sparse matrix-vector product ``y = A @ x`` (``A`` a container or a
    ``SparseOperator``; ``policy`` wins over the legacy ``impl`` string)."""
    A = _unwrap(A)
    return _dispatch_spmv(A, x, _shim_policy(A, impl, policy, _SPMV))


def spmm(A, X, impl: Optional[str] = None, *,
         policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Sparse @ dense-matrix product ``Y = A @ X`` (``X`` is ``(ncols, k)``)."""
    A = _unwrap(A)
    return _dispatch_spmm(A, X, _shim_policy(A, impl, policy, _SPMM))


# ---------------------------------------------------------------- plain ----


def _zero(dtype, device) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=device)


def _csr_logical_nnz(A: CSR) -> int:
    """``indptr[-1]``: entries past it are padding (read once per container)."""
    n = A.__dict__.get("_logical_nnz")
    if n is None:
        n = int(A.indptr[-1])
        object.__setattr__(A, "_logical_nnz", n)
    return n


def _segment_sum(A, prod: torch.Tensor, **segments) -> torch.Tensor:
    """``torch.segment_reduce(prod, "sum", **segments)`` over ``A``'s
    segments: checked on the first call for a container, unchecked after.
    The check reads the device, which a solve captured in a CUDA graph may
    not do; the sums are the same."""
    checked = A.__dict__.get("_segments_checked", False)
    y = torch.segment_reduce(prod, "sum", unsafe=checked, **segments)
    if not checked:
        object.__setattr__(A, "_segments_checked", True)
    return y


def _coo_plain_rows(A: COO):
    """``(col, val, offsets)``: ``A``'s entries in row order (their stable
    row sort where the rows go down somewhere) and each row's segment
    bounds (pad sentinels lie past the last). Kept in ``A.cache``, so the
    order flag is read from the device once a container (never where the
    container is marked ``UNSORTED``: the sort is then always taken)."""
    got = A.cache.get("plain_rows")
    if got is None:
        from repro_torch.kernels.coo_spmv import UNSORTED, row_sorted

        check = not A.cache.get(UNSORTED, False)
        row, col, val, _ = row_sorted(A.row, A.col, A.val, check)
        bounds = torch.arange(A.shape[0] + 1, dtype=row.dtype, device=row.device)
        got = A.cache["plain_rows"] = (col, val, torch.searchsorted(row, bounds))
    return got


@register_spmv("coo", "plain")
def coo_spmv_plain(A: COO, x):
    """Algorithm 1: y[ai[i]] += av[i] * x[aj[i]], as a segment sum over the
    entries in row order (pad sentinels sort past the last row). Entries in
    any order: unsorted rows are summed through their stable row sort, so
    one row's entries still add in entry order, as the reference's
    scatter-add does."""
    col, val, offsets = _coo_plain_rows(A)
    return _segment_sum(A, val * x[col.long()], offsets=offsets)


@register_spmv("csr", "plain")
def csr_spmv_plain(A: CSR, x):
    """Algorithm 2: each row's products summed over its indptr segment."""
    nnz = _csr_logical_nnz(A)
    prod = A.data[:nnz] * x[A.indices[:nnz].long()]
    return _segment_sum(A, prod, offsets=A.indptr)


@register_spmv("dia", "plain")
def dia_spmv_plain(A: DIA, x):
    """Algorithm 3: inner loop over diagonals, rows vectorised. Accumulates
    in the promoted product dtype (f32 for bf16/f16 storage and f32 x)."""
    nrows, ncols = A.shape
    i = torch.arange(nrows, device=A.data.device)
    acc = torch.promote_types(A.dtype, x.dtype)
    y = torch.zeros((nrows,), dtype=acc, device=A.data.device)
    for d in range(A.ndiags):
        k = i + A.offsets[d].long()
        valid = (k >= 0) & (k < ncols)
        xk = x[k.clamp(0, ncols - 1)]
        y = y + torch.where(valid, A.data[d] * xk, _zero(acc, y.device))
    return y


@register_spmv("ell", "plain")
def ell_spmv_plain(A: ELL, x):
    valid = A.indices >= 0
    xk = x[torch.where(valid, A.indices, 0).long()]
    prod = A.data * xk
    return torch.where(valid, prod, _zero(prod.dtype, prod.device)).sum(dim=1)


def _sell_lane_order(A: SELL):
    """(order, lengths): entries gathered lane by lane — each slice row's
    entries in ascending j — and the per-slice-row entry counts, for a
    segment sum. Cached on the container."""
    cached = A.__dict__.get("_lane_order")
    if cached is None:
        C = A.C
        sptr = A.sptr.long()
        widths = sptr[1:] - sptr[:-1]                       # (nslices,)
        lengths = widths.repeat_interleave(C)               # per slice row
        p = torch.arange(lengths.shape[0], device=sptr.device)
        s, lane = p // C, p % C
        start = sptr[s] * C + lane                          # j = 0 entry
        seg = torch.repeat_interleave(p, lengths)
        first = torch.cumsum(lengths, 0) - lengths
        j = torch.arange(seg.shape[0], device=sptr.device) - first[seg]
        order = start[seg] + j * C
        cached = (order, lengths)
        object.__setattr__(A, "_lane_order", cached)
    return cached


@register_spmv("sell", "plain")
def sell_spmv_plain(A: SELL, x):
    """Each slice row's products summed in ascending j, then un-permuted."""
    nrows = A.shape[0]
    order, lengths = _sell_lane_order(A)
    idx = A.indices[order]
    valid = idx >= 0
    prod = A.data[order] * x[torch.where(valid, idx, 0).long()]
    prod = torch.where(valid, prod, _zero(prod.dtype, prod.device))
    yp = _segment_sum(A, prod, lengths=lengths)
    y = torch.zeros((nrows + 1,), dtype=yp.dtype, device=yp.device)
    y[A.perm.long().clamp(max=nrows)] = yp
    return y[:nrows]


@register_spmv("bsr", "plain")
def bsr_spmv_plain(A: BSR, x):
    nrows, ncols = A.shape
    bs = A.bs
    nbcols = -(-ncols // bs)
    xp = torch.zeros((nbcols * bs,), dtype=x.dtype, device=x.device)
    xp[:ncols] = x
    xb = xp.reshape(nbcols, bs)
    valid = (A.bcols >= 0)[..., None]
    xg = torch.where(valid, xb[torch.where(A.bcols >= 0, A.bcols, 0).long()],
                     _zero(x.dtype, x.device))
    blocks = A.blocks.to(torch.promote_types(A.dtype, x.dtype))
    y = torch.einsum("rwij,rwj->ri", blocks, xg.to(blocks.dtype)).reshape(-1)
    return y[:nrows]


@register_spmv("dense", "plain")
@register_spmv("dense", "dense")
def dense_spmv(A: Dense, x):
    return _promoted_matmul(A.data, x)


# ---------------------------------------------------------- masked plain ----


@register_masked_spmv("csr", "plain")
def csr_masked_spmv_plain(A: CSR, x, row_mask):
    """Rows outside the mask are exactly zero; the rest are the unmasked
    sums (the same values the reference's predicated scatter gives)."""
    return _mask_rows(csr_spmv_plain(A, x), row_mask)


@register_masked_spmv("coo", "plain")
def coo_masked_spmv_plain(A: COO, x, row_mask):
    return _mask_rows(coo_spmv_plain(A, x), row_mask)


@register_masked_spmv("ell", "plain")
def ell_masked_spmv_plain(A: ELL, x, row_mask):
    valid = (A.indices >= 0) & row_mask[:, None]
    xk = x[torch.where(A.indices >= 0, A.indices, 0).long()]
    prod = A.data * xk
    return torch.where(valid, prod, _zero(prod.dtype, prod.device)).sum(dim=1)


@register_masked_spmv("dia", "plain")
def dia_masked_spmv_plain(A: DIA, x, row_mask):
    nrows, ncols = A.shape
    i = torch.arange(nrows, device=A.data.device)
    acc = torch.promote_types(A.dtype, x.dtype)
    y = torch.zeros((nrows,), dtype=acc, device=A.data.device)
    for d in range(A.ndiags):
        k = i + A.offsets[d].long()
        valid = (k >= 0) & (k < ncols) & row_mask
        xk = x[k.clamp(0, ncols - 1)]
        y = y + torch.where(valid, A.data[d] * xk, _zero(acc, y.device))
    return y


@register_masked_spmv("bsr", "plain")
def bsr_masked_spmv_plain(A: BSR, x, row_mask):
    nbrows, bs = A.bcols.shape[0], A.bs
    m = torch.zeros((nbrows * bs,), dtype=torch.bool, device=row_mask.device)
    m[: A.shape[0]] = row_mask
    blocks = A.blocks * m.reshape(nbrows, 1, bs, 1).to(A.blocks.dtype)
    return bsr_spmv_plain(BSR(A.bcols, blocks, A.shape), x)


# ------------------------------------------------------- dense fallback ----

def _promoted_matmul(a, b):
    """``a @ b`` in the promoted dtype (torch's matmul wants one dtype)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _via_dense(A, x):
    return _promoted_matmul(A.to_dense(), x)


for _fmt in ("coo", "csr", "dia", "ell", "sell", "bsr"):
    register_spmv(_fmt, "dense")(_via_dense)


# ------------------------------------------------------------------ SpMM ----

@register_spmm("bsr", "plain")
@register_spmm("bsr", "dense")
def _bsr_spmm_plain(A: BSR, X):
    nrows, ncols = A.shape
    bs, nf = A.bs, X.shape[1]
    nbcols = -(-ncols // bs)
    Xp = torch.zeros((nbcols * bs, nf), dtype=X.dtype, device=X.device)
    Xp[:ncols] = X
    Xb = Xp.reshape(nbcols, bs, nf)
    valid = (A.bcols >= 0)[..., None, None]
    Xg = torch.where(valid, Xb[torch.where(A.bcols >= 0, A.bcols, 0).long()],
                     _zero(X.dtype, X.device))
    blocks = A.blocks.to(torch.promote_types(A.dtype, X.dtype))
    Y = torch.einsum("rwij,rwjf->rif", blocks, Xg.to(blocks.dtype)).reshape(-1, nf)
    return Y[:nrows]
