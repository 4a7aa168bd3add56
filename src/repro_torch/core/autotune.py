"""Run-first auto-tuner (paper §VII-D).

Given a matrix, convert it to each candidate ``DispatchKey(format,
backend)``, time its SpMV, and return the winner with the full timing
table — ``repro.core.autotune`` with ``cuda`` in place of ``pallas``.
Conversion cost is excluded. On a CUDA device each timed call ends in
``torch.cuda.synchronize()``.

A candidate runs through the normal dispatch chain ``(impl, "plain")``.
On the host this keeps the reference's semantics: a ``cuda`` kernel that
raises falls to plain, the failure is recorded in the ambient
``core.health`` registry, and the race still reports a time for that key —
read the health snapshot to tell a kernel that ran from one that fell back.
On a CUDA device a raising ``cuda`` kernel raises out of dispatch, and the
race lists the key in ``skipped`` as ``error: KernelExecutionError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .convert import col_tile_for_policy as _col_tile_for_policy
from .convert import container_to_scipy as _container_to_scipy
from .convert import from_dense as _from_dense
from .formats import resolve_device
from .operator import DEFAULT_POLICY, ExecutionPolicy, SparseOperator
from .spmv import DispatchKey, available_impls, spmv

DEFAULT_CANDIDATES: Tuple[DispatchKey, ...] = (
    DispatchKey("coo", "plain"), DispatchKey("coo", "cuda"),
    DispatchKey("csr", "plain"), DispatchKey("csr", "cuda"),
    DispatchKey("dia", "plain"), DispatchKey("dia", "cuda"),
    DispatchKey("ell", "plain"), DispatchKey("ell", "cuda"),
    DispatchKey("sell", "plain"), DispatchKey("sell", "cuda"),
    DispatchKey("bsr", "plain"), DispatchKey("bsr", "cuda"),
    DispatchKey("dense", "dense"),
)

#: Formats whose converters take a ``col_tile`` argument (tiled plans).
_COL_TILED_FORMATS = ("coo", "csr", "dia", "ell", "sell")


@dataclass
class TuneResult:
    format: str
    impl: str
    time_us: float
    matrix: object
    table: Dict[Tuple[str, str], float] = field(default_factory=dict)
    skipped: List[Tuple[str, str, str]] = field(default_factory=list)
    base_policy: Optional[ExecutionPolicy] = None  # limits candidates ran under

    @property
    def key(self) -> DispatchKey:
        return DispatchKey(self.format, self.impl)

    @property
    def operator(self) -> SparseOperator:
        """The tuned matrix as a retargeted SparseOperator."""
        base = self.base_policy if self.base_policy is not None else DEFAULT_POLICY
        return SparseOperator(self.matrix, base.preferring(self.impl))

    def __repr__(self):
        return f"TuneResult(format={self.format!r}, impl={self.impl!r}, {self.time_us:.1f}us)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(fn, *args, iters: int = 10, warmup: int = 3, device=None) -> float:
    """Median host time of ``fn(*args)`` in microseconds, each call waited
    for on the device."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter_ns()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter_ns() - t0)
    return float(np.median(ts)) / 1e3


def _normalize_candidates(candidates) -> Tuple[Tuple[str, str], ...]:
    return tuple((fmt, impl) for fmt, impl in candidates)


def structural_skip(s, fmt: str, dia_max_diags: int = 512,
                    ell_max_width_factor: float = 4.0,
                    bsr_min_block_fill: float = 0.125) -> Optional[str]:
    """Why ``fmt`` should not even be *built* for matrix ``s`` — or ``None``:
    DIA with too many distinct diagonals, ELL whose widest row far exceeds
    the mean, BSR whose 32-edge block fill is too low.

    Example:
        >>> import scipy.sparse as sp
        >>> structural_skip(sp.eye(64, format="csr"), "dia") is None
        True
    """
    s = s.tocsr()
    if s.nnz and not s.data.all():
        s = s.copy()
        s.eliminate_zeros()
    if fmt == "dia":
        coo = s.tocoo()
        ndiags = len(np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64)))
        if ndiags > dia_max_diags:
            return f"ndiags={ndiags}>{dia_max_diags}"
    if fmt == "ell":
        counts = np.diff(s.indptr)
        mean_w = max(1.0, counts.mean() if len(counts) else 1.0)
        if len(counts) and counts.max() > ell_max_width_factor * mean_w + 8:
            return f"max_row={counts.max()} >> mean={mean_w:.1f}"
    if fmt == "bsr" and s.nnz:
        from .features import BSR_FEATURE_BLOCK, block_density

        coo = s.tocoo()
        fill = block_density(coo.row, coo.col, s.shape[0], s.shape[1],
                             BSR_FEATURE_BLOCK)
        if fill < bsr_min_block_fill:
            return f"block_fill={fill:.3f}<{bsr_min_block_fill}"
    return None


def autotune_spmv(
    a_dense,
    candidates: Optional[Sequence] = None,
    iters: int = 10,
    warmup: int = 3,
    dia_max_diags: int = 512,
    ell_max_width_factor: float = 4.0,
    dtype=None,
    policy: Optional[ExecutionPolicy] = None,
    prune: Optional[int] = None,
    time_fn=None,
    device="cuda",
) -> TuneResult:
    """Pick the fastest (format, backend) for ``a_dense``.

    ``a_dense`` may be dense, scipy sparse, a container, or a
    ``SparseOperator``; the candidates are built on ``device`` (default
    ``"cuda"``). ``time_fn(fn, A, x, key, iters=, warmup=) -> us`` overrides
    the timer. ``prune=`` needs the zero-run selector, which is not ported
    yet (ROADMAP queue 1, item 4) and raises.
    """
    import scipy.sparse as sp

    if prune:
        raise NotImplementedError(
            "autotune_spmv(prune=) needs the zero-run selector, not ported yet "
            "(ROADMAP queue 1, item 4: core/select.py)")
    dev = resolve_device(device)
    if isinstance(a_dense, SparseOperator):
        a_dense = a_dense.container
    if hasattr(a_dense, "to_dense") and not sp.issparse(a_dense):
        a_dense = _container_to_scipy(a_dense)
    if isinstance(a_dense, torch.Tensor):
        a_dense = a_dense.detach().cpu().numpy()
    s = a_dense if sp.issparse(a_dense) else sp.csr_matrix(np.asarray(a_dense))
    s = s.tocsr()
    n = s.shape[1]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32)).to(dev)

    table: Dict[Tuple[str, str], float] = {}
    skipped: List[Tuple[str, str, str]] = []
    mats = {}
    skip_cache: Dict[str, Optional[str]] = {}
    cand = _normalize_candidates(candidates if candidates is not None else DEFAULT_CANDIDATES)
    for fmt, impl in cand:
        if fmt not in skip_cache:
            skip_cache[fmt] = structural_skip(s, fmt, dia_max_diags,
                                              ell_max_width_factor)
        why = skip_cache[fmt]
        if why is not None:
            skipped.append((fmt, impl, why))
            continue
        if impl not in available_impls(fmt):
            skipped.append((fmt, impl, "impl not registered"))
            continue
        if fmt not in mats:
            kw = {"dtype": dtype} if dtype is not None else {}
            if fmt in _COL_TILED_FORMATS:
                base = policy if policy is not None else DEFAULT_POLICY
                kw["col_tile"] = _col_tile_for_policy(fmt, n, base.col_tile(n))
            mats[fmt] = _from_dense(s, fmt, device=dev, **kw)
        A = mats[fmt]
        pol = (policy if policy is not None else DEFAULT_POLICY).preferring(impl)
        fn = lambda A, x, pol=pol: spmv(A, x, policy=pol)  # noqa: E731
        try:
            if time_fn is not None:
                table[(fmt, impl)] = time_fn(fn, A, x, DispatchKey(fmt, impl),
                                             iters=iters, warmup=warmup)
            else:
                table[(fmt, impl)] = _time_call(fn, A, x, iters=iters,
                                                warmup=warmup, device=dev)
        except Exception as e:  # the chain itself exhausted: record, go on racing
            skipped.append((fmt, impl, f"error: {type(e).__name__}"))

    if not table:
        raise RuntimeError("auto-tuner: no candidate succeeded")
    (fmt, impl), t = min(table.items(), key=lambda kv: kv[1])
    return TuneResult(fmt, impl, t, mats[fmt], table, skipped, base_policy=policy)

