"""Run-first auto-tuner (paper §VII-D).

Given a matrix, convert it to each candidate ``DispatchKey(format,
backend)``, time its SpMV, and return the winner with the full timing
table — ``repro.core.autotune`` with ``cuda`` in place of ``pallas``.
Conversion cost is excluded. On a CUDA device each timed call ends in
``torch.cuda.synchronize()``.

The reference times each candidate's ``jax.jit``-compiled call
(``repro.core.autotune``: ``fn = jax.jit(lambda A, x: spmv(A, x,
policy=pol))``). On a CUDA device the port races captured calls the same
way (``graph=None`` or ``True``): each candidate's ``spmv`` is captured
once in a CUDA graph through :func:`repro_torch.capture.capture` (its
warm-up is the eager call that builds every first-call cache), the race
times the graph's replays by ``_time_call``'s rule, and the last replay must
give the warm-up's bits (a mismatch raises: it is a fault of the port). A
capture that fails lists the key in ``skipped`` as ``error: CaptureError``,
as the reference lists a lowering gap. Each candidate's graph is freed
before the next one is captured. Python runs only at the warm-up and the
capture, so launch counters and the health registry count those two calls
and never a replay. ``graph=False`` races the eager calls; on the host the
race is always eager and ``graph=True`` raises.

A candidate runs through the normal dispatch chain ``(impl, "plain")``.
On the host this keeps the reference's semantics: a ``cuda`` kernel that
raises falls to plain, the failure is recorded in the ambient
``core.health`` registry, and the race still reports a time for that key —
read the health snapshot to tell a kernel that ran from one that fell back.
On a CUDA device a raising ``cuda`` kernel raises out of dispatch, and the
race lists the key in ``skipped`` as ``error: KernelExecutionError``; a
``cuda`` key whose predicate rejects the container is not timed either (the
chain would run plain under its label) and is listed as ``unsupported``.
"""
from __future__ import annotations

import importlib
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
from .spmv import DispatchKey, available_impls, dispatch_table, spmv

#: The dispatch module itself (``core.spmv``; the package's ``spmv`` name is
#: the function): the tuner asks its ``_on_card`` rule, as dispatch does.
_dispatch = importlib.import_module(__package__ + ".spmv")

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
    graph: bool = False          # the candidates were timed by a CUDA graph's replays
    capture_s: float = 0.0       # the race's capture seconds, summed over candidates
    instantiate_s: float = 0.0   # and its instantiation seconds
    replay_equal: int = 0        # captured candidates whose replay gave the eager bits

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


def _capturable(dev: torch.device) -> bool:
    """A race on ``dev`` is timed by CUDA graphs' replays (by default)."""
    return dev.type == "cuda"


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bits (a NaN equals a NaN of the same bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(as_int), b.view(as_int)
    return torch.equal(a, b)


class _CapturedCall:
    """One race candidate's ``spmv(A, x, policy=pol)`` captured in a CUDA
    graph: ``call(A, x)`` replays it and returns the static output, for the
    captured ``A`` and ``x`` only.

    Raises:
        CaptureError: the capture failed.
    """

    def __init__(self, A, x: torch.Tensor, pol: ExecutionPolicy, what: str):
        from repro_torch.capture import capture

        self.A, self.x, self.what = A, x, what
        self._cap = capture(lambda: spmv(A, x, policy=pol), x.device, what, keep_warm=True)
        self.capture_s, self.instantiate_s = self._cap.capture_s, self._cap.instantiate_s

    def __call__(self, A, x) -> torch.Tensor:
        if A is not self.A or x is not self.x:
            raise ValueError(f"{self.what} was captured for its own matrix and x; "
                             f"a replay cannot take other tensors")
        self._cap.graph.replay()
        return self._cap.out

    def check(self) -> None:
        """One more replay, held to the warm-up's output bit for bit.

        Raises:
            RuntimeError: the replay's bits differ from the eager call's.
        """
        if not _same_bits(self(self.A, self.x), self._cap.warm):
            raise RuntimeError(f"{self.what}: the CUDA graph's replay differs from the "
                               f"eager call's bits")

    def free(self) -> None:
        """Release the graph and its pool's tensors."""
        self._cap.graph.reset()
        self._cap = None


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


def _pruned(s, cand, keep: int, policy, dev, dia_max_diags, ell_max_width_factor,
            skipped) -> Tuple[Tuple[str, str], ...]:
    """The candidates ``prune=keep`` races: the selector's top ``keep`` and
    every structurally infeasible key (skipped later with its structural
    reason, not blamed on the selector); the others go to ``skipped``."""
    from . import select
    from .features import extract_features

    feats = extract_features(s)
    keep_keys = {(k.format, k.backend) for k in select.prune_candidates(
        feats, keep, policy=policy if policy is not None else DEFAULT_POLICY,
        candidates=cand, platform=dev.type, dia_max_diags=dia_max_diags,
        ell_max_width_factor=ell_max_width_factor)}
    out = []
    for fmt, impl in cand:
        if (fmt, impl) in keep_keys or select.infeasible(
                feats, fmt, dia_max_diags, ell_max_width_factor) is not None:
            out.append((fmt, impl))
        else:
            skipped.append((fmt, impl, "pruned by selector"))
    return tuple(out)


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
    graph: Optional[bool] = None,
) -> TuneResult:
    """Pick the fastest (format, backend) for ``a_dense``.

    ``a_dense`` may be dense, scipy sparse, a container, or a
    ``SparseOperator``; the candidates are built on ``device`` (default
    ``"cuda"``). ``time_fn(fn, A, x, key, iters=, warmup=) -> us`` overrides
    the timer. ``prune=k`` races only the top-``k`` candidates of the
    zero-run selector's ranking on the cost table of ``device``; pruned keys
    land in ``skipped`` as ``"pruned by selector"``, while structurally
    infeasible ones keep their structural reason.

    ``graph=None`` races captured calls on a CUDA device and eager calls on
    the host; ``graph=True`` captures and raises ``ValueError`` off the card,
    before any conversion; ``graph=False`` races eager calls everywhere.
    With a graph, ``time_fn``'s ``fn(A, x)`` replays the candidate's graph
    and returns its static output. The result records whether the race was
    captured and its capture and instantiation seconds.
    """
    import scipy.sparse as sp

    dev = resolve_device(device)
    if graph and not _capturable(dev):
        raise ValueError(f"autotune_spmv(graph=True) races CUDA graphs and needs a CUDA "
                         f"device, got {dev}; pass graph=False or None to race eager calls")
    captured = _capturable(dev) if graph is None else bool(graph)
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
    graph_s = {"capture_s": 0.0, "instantiate_s": 0.0, "replay_equal": 0}
    mats = {}
    skip_cache: Dict[str, Optional[str]] = {}
    cand = _normalize_candidates(candidates if candidates is not None else DEFAULT_CANDIDATES)
    if prune:
        cand = _pruned(s, cand, int(prune), policy, dev, dia_max_diags,
                       ell_max_width_factor, skipped)
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
        if (impl == "cuda" and _dispatch._on_card(x)
                and not dispatch_table("spmv")[DispatchKey(fmt, impl)].ok(A, pol)):
            skipped.append((fmt, impl, "unsupported"))
            continue
        fn = lambda A, x, pol=pol: spmv(A, x, policy=pol)  # noqa: E731
        call = fn
        try:
            if captured:
                call = _CapturedCall(A, x, pol, f"the race candidate {fmt}/{impl}")
                graph_s["capture_s"] += call.capture_s
                graph_s["instantiate_s"] += call.instantiate_s
            if time_fn is not None:
                table[(fmt, impl)] = time_fn(call, A, x, DispatchKey(fmt, impl),
                                             iters=iters, warmup=warmup)
            else:
                table[(fmt, impl)] = _time_call(call, A, x, iters=iters,
                                                warmup=warmup, device=dev)
        except Exception as e:  # the chain itself exhausted: record, go on racing
            skipped.append((fmt, impl, f"error: {type(e).__name__}"))
            if call is not fn:
                call.free()
            continue
        if call is not fn:
            try:
                call.check()
            finally:
                call.free()
            graph_s["replay_equal"] += 1

    if not table:
        raise RuntimeError("auto-tuner: no candidate succeeded")
    (fmt, impl), t = min(table.items(), key=lambda kv: kv[1])
    return TuneResult(fmt, impl, t, mats[fmt], table, skipped, base_policy=policy,
                      graph=captured, **graph_s)

