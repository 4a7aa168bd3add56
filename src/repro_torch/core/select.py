"""Zero-run (format, backend) selection from structural features.

The PyTorch counterpart of ``repro.core.select``: map
:class:`~repro_torch.core.features.MatrixFeatures` plus an
:class:`~repro_torch.core.operator.ExecutionPolicy` to a ranked list of
``DispatchKey``s without running a kernel. The run-first tuner
(``core/autotune.py``) stays the oracle.

The model is a per-(format, backend, strategy) cost estimate

    est_us = a + b * krows + c * kentries + d * krows * kentries

(``krows = nrows/1000``, ``kentries = stored_entries/1000``), where
``stored_entries`` is the format's padded storage volume derived from the
features and the strategy (``cuda`` resident vs column-tiled) follows the
policy's column limit as dispatch does. Structural infeasibility mirrors
``autotune.structural_skip``, so a ranking never proposes a candidate the
tuner would refuse to build. Beyond the reference, a ``cuda`` key whose
predicate would reject the container the tuner builds (an f64 policy; COO
with more rows than the full window and no column-tile plan) is never
proposed either: on the card dispatch would run plain under its label.

Two cost tables:

  - ``"cpu"``: the reference's table, fit to interpreted Pallas on a CPU
    runner, with ``pallas`` renamed ``cuda``, so ``rank(...,
    platform="cpu")`` reproduces the reference's ranking. It describes no
    device of the port and prices nothing on the card.
  - ``"cuda"``: the card's and every other platform's, the role of the
    reference's analytic fall-back. Uncalibrated (no fit has been run):
    each row is one ``a + c * kentries`` line through one measurement of
    ``chip_smoke.py`` on an H100.

``platform`` defaults to the device type of the operand (``"cuda"`` or
``"cpu"``) and to ``"cuda"`` for inputs without a device (features, scipy).

Consumers: ``SparseOperator.tune(mode="predict")``, ``autotune_spmv(prune=k)``,
``VCycle.retuned(mode="predict")`` and ``run_hpcg(tune_mode="predict")``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import tiling
from .features import MatrixFeatures, extract_features
from .operator import DEFAULT_POLICY, ExecutionPolicy
from .spmv import DispatchKey

#: Structural-guard thresholds — shared with ``autotune.structural_skip``.
DIA_MAX_DIAGS = 512
ELL_MAX_WIDTH_FACTOR = 4.0
#: BSR is refused when the 32-edge block fill drops below this.
BSR_MIN_BLOCK_FILL = 0.125

#: Value dtypes the ``cuda`` kernels take (``kernels.ops._precision_ok``).
_CUDA_VALUE_DTYPES = ("float32", "bfloat16", "float16")

CostTable = Dict[Tuple[str, str, str], Tuple[float, float, float, float]]

COST: Dict[str, CostTable] = {
    # the reference's "cpu" table (repro/core/select.py), pallas -> cuda
    "cpu": {
        ("coo", "cuda", "resident"): (53.223, 371.154, 0.0, 347.27),
        ("coo", "cuda", "tiled"): (232.349, 8706.024, 0.0, 96.14),
        ("coo", "plain", ""): (0.0, 192.954, 50.758, 0.0),
        ("csr", "cuda", "resident"): (120.823, 169.644, 15.784, 37.248),
        ("csr", "cuda", "tiled"): (65.959, 930.806, 0.0, 135.13),
        ("csr", "plain", ""): (96.052, 68.206, 55.797, 6.725),
        ("dense", "dense", ""): (22.084, 31.091, 0.25, 0.0),
        ("dia", "cuda", "resident"): (10.513, 0.0, 0.118, 3.832),
        ("dia", "cuda", "tiled"): (226.402, 0.0, 16.959, 0.0),
        ("dia", "plain", ""): (2.888, 80.675, 2.808, 0.0),
        ("ell", "cuda", "resident"): (40.064, 0.0, 0.421, 8.196),
        ("ell", "cuda", "tiled"): (27.837, 730.713, 0.0, 110.608),
        ("ell", "plain", ""): (46.548, 0.0, 2.248, 0.11),
        ("sell", "cuda", "resident"): (114.122, 85.527, 25.383, 24.511),
        ("sell", "cuda", "tiled"): (30.455, 1565.35, 0.0, 108.465),
        ("sell", "plain", ""): (85.504, 0.0, 53.976, 2.465),
        ("bsr", "plain", ""): (60.0, 0.0, 1.2, 0.05),
        ("bsr", "cuda", "block"): (90.0, 420.0, 0.0, 55.0),
    },
    # One line a + c * kentries per key through one chip_smoke.py phase 2
    # measurement on an NVIDIA H100 80GB HBM3 at power limit 700.00 W (PERF.md
    # names the runs): a = the host time of one call (CUDA-event ms minus the
    # kernel's profiler time; a plain key took its format's cuda a when its
    # line was drawn, and keeps it until a plain run measures it), c = the
    # device time per thousand stored entries at int32/f32 width, on HPCG's
    # fdm27 grid (52^3 resident, 104^3 tiled, 13^3 resident COO; tiled DIA
    # under max_resident_cols=1<<18) or, for bsr, on
    # block_random(65536, 32, 16/2048). The csr, sell and bsr c come from
    # examples/cuda_cost_lines.py after their kernels' redesign; their a stays
    # the one measured before it: the csr/sell wrapper's host time per call
    # did not change (examples/scs_wrapper_ab.py), and the bsr wrapper's host
    # work gained only two pointer checks. Uncalibrated: no fit has been run.
    "cuda": {
        ("coo", "cuda", "resident"): (77.52, 0.0, 0.0884449, 0.0),
        ("coo", "cuda", "tiled"): (65.15, 0.0, 0.00500898, 0.0),
        ("coo", "plain", ""): (77.52, 0.0, 0.195008, 0.0),
        ("csr", "cuda", "resident"): (48.5, 0.0, 0.00607523, 0.0),
        ("csr", "cuda", "tiled"): (32.0, 0.0, 0.00597676, 0.0),
        ("csr", "plain", ""): (48.5, 0.0, 0.139338, 0.0),
        ("dia", "cuda", "resident"): (48.5, 0.0, 0.00165617, 0.0),
        ("dia", "cuda", "tiled"): (31.4, 0.0, 0.00327941, 0.0),
        ("dia", "plain", ""): (48.5, 0.0, 0.0757129, 0.0),
        ("ell", "cuda", "resident"): (53.6, 0.0, 0.00979872, 0.0),
        ("ell", "cuda", "tiled"): (68.02, 0.0, 0.00486554, 0.0),
        ("ell", "plain", ""): (53.6, 0.0, 1.06664, 0.0),
        ("sell", "cuda", "resident"): (48.5, 0.0, 0.0055489, 0.0),
        ("sell", "cuda", "tiled"): (32.0, 0.0, 0.00551783, 0.0),
        ("sell", "plain", ""): (48.5, 0.0, 0.128639, 0.0),
        ("bsr", "plain", ""): (78.4, 0.0, 0.0231596, 0.0),
        ("bsr", "cuda", "block"): (78.4, 0.0, 0.00155187, 0.0),
    },
}


@dataclass(frozen=True)
class Prediction:
    """One ranked candidate: the key, its cost estimate, and why."""

    key: DispatchKey
    est_us: float
    reason: str

    def __repr__(self):
        return (f"Prediction({self.key.format}/{self.key.backend}, "
                f"{self.est_us:.1f}us, {self.reason!r})")


def storage_entries(f: MatrixFeatures, fmt: str) -> float:
    """Stored scalar entries (padding included) of ``f`` in format ``fmt`` —
    the volume term of the cost model.

    Example:
        >>> import scipy.sparse as sp
        >>> from repro_torch.core.features import extract_features
        >>> f = extract_features(sp.eye(16, format="csr"))
        >>> storage_entries(f, "csr"), storage_entries(f, "dia")
        (16.0, 16.0)
        >>> storage_entries(f, "dense")
        256.0
    """
    if fmt in ("coo", "csr"):
        return float(f.nnz)
    if fmt == "dia":
        return float(f.ndiags * f.nrows)
    if fmt == "ell":
        return float(f.nrows * max(f.rownnz_max, 1))
    if fmt == "sell":
        # slices pad to their own width; with σ-sorting the overhead is a
        # fraction of ELL's — estimate via the row-length spread
        spread = min(f.rownnz_std / max(f.rownnz_mean, 1.0), 1.0)
        return float(f.nnz) * (1.0 + 0.5 * spread) + float(f.nrows)
    if fmt == "dense":
        return float(f.nrows) * float(f.ncols)
    if fmt == "bsr":
        # nnz / fill at BSR's own 32-edge granularity = padded block volume
        return float(f.nnz) / max(f.block_density32, 1e-3)
    return float(f.nnz)


def plan_index_dtype(ncols: int, policy: ExecutionPolicy) -> np.dtype:
    """Index dtype a kernel plan built for an ``ncols``-wide matrix under
    ``policy`` would carry (``tiling.local_index_dtype`` at build time).
    Raises ``ValueError`` when the policy pins a dtype the tile width cannot
    hold.

    Example:
        >>> plan_index_dtype(96, DEFAULT_POLICY)
        dtype('int8')
    """
    ct = policy.col_tile(ncols) or max(1, ncols)
    return tiling.local_index_dtype(ct, policy.index_dtype)


def index_bytes(f: MatrixFeatures, fmt: str, policy: ExecutionPolicy,
                strategy: str) -> float:
    """Per-stored-entry index bytes the SpMV streams for this (format,
    strategy): int32 global ids for plain/resident kernels, the plan's
    tile-local ids for the column-tiled strategies and the csr/sell SCS
    stream, none for DIA, dense and BSR."""
    if fmt in ("dia", "dense", "bsr"):
        return 0.0
    local = (fmt in ("csr", "sell")) or strategy == "tiled"
    ib = plan_index_dtype(f.ncols, policy).itemsize if local else 4
    if fmt == "coo":
        return 4.0 + ib  # int32 global rows ride along with every entry
    return float(ib)


def storage_bytes(f: MatrixFeatures, fmt: str,
                  policy: Optional[ExecutionPolicy] = None,
                  strategy: str = "") -> float:
    """Storage volume in bytes of ``f`` as ``fmt`` under the policy's
    precision knobs, plus the per-row/per-diagonal metadata the format
    keeps (CSR's indptr, SELL's sptr+perm, DIA's offsets)."""
    policy = policy if policy is not None else DEFAULT_POLICY
    vb = policy.torch_value_dtype().itemsize
    entries = storage_entries(f, fmt)
    per_entry = vb + index_bytes(f, fmt, policy, strategy)
    overhead = {"csr": 4.0 * (f.nrows + 1), "sell": 8.0 * f.nrows,
                "dia": 4.0 * f.ndiags}.get(fmt, 0.0)
    return entries * per_entry + overhead


def bytes_per_nnz(f: MatrixFeatures, fmt: str,
                  policy: Optional[ExecutionPolicy] = None,
                  strategy: str = "") -> float:
    """Streamed bytes per logical nonzero.

    Example:
        >>> import scipy.sparse as sp
        >>> from repro_torch.core.features import extract_features
        >>> f = extract_features(sp.eye(64, format="csr"))
        >>> b32 = bytes_per_nnz(f, "ell", DEFAULT_POLICY.replace(index_dtype="int32"))
        >>> bauto = bytes_per_nnz(f, "ell", DEFAULT_POLICY, strategy="tiled")
        >>> bauto < b32   # int8 local indices beat int32 global ones
        True
    """
    return storage_bytes(f, fmt, policy, strategy) / max(1, f.nnz)


def infeasible(f: MatrixFeatures, fmt: str,
               dia_max_diags: int = DIA_MAX_DIAGS,
               ell_max_width_factor: float = ELL_MAX_WIDTH_FACTOR,
               bsr_min_block_fill: float = BSR_MIN_BLOCK_FILL,
               ) -> Optional[str]:
    """Feature-level mirror of ``autotune.structural_skip``: why ``fmt``
    should not even be built, or ``None``.

    Example:
        >>> import scipy.sparse as sp
        >>> from repro_torch.core.features import extract_features
        >>> infeasible(extract_features(sp.eye(64, format="csr")), "dia")
    """
    if fmt == "dia" and f.ndiags > dia_max_diags:
        return f"ndiags={f.ndiags}>{dia_max_diags}"
    if fmt == "ell":
        mean_w = max(1.0, f.rownnz_mean)
        if f.rownnz_max > ell_max_width_factor * mean_w + 8:
            return f"max_row={f.rownnz_max} >> mean={mean_w:.1f}"
    if fmt == "bsr" and f.nnz and f.block_density32 < bsr_min_block_fill:
        return f"block_fill={f.block_density32:.3f}<{bsr_min_block_fill}"
    return None


#: the uncompressed pricing baseline of the bandwidth scaling — int32
#: indices, f32 values
_UNCOMPRESSED = ExecutionPolicy(index_dtype="int32", value_dtype="float32")


def platform_of(a) -> str:
    """The cost table for ``a``: its device type (``"cuda"`` or
    ``"cpu"``), or ``"cuda"`` for inputs that lie on no device."""
    dev = getattr(a, "device", None)
    return torch.device(dev).type if dev is not None else "cuda"


def cuda_strategy_for(f: MatrixFeatures, policy: ExecutionPolicy,
                      fmt: str) -> Optional[str]:
    """Which ``cuda`` strategy the policy implies for this matrix — the
    feature-level twin of ``kernels.ops.cuda_strategy`` (which needs the
    built container) — or ``None`` where the predicate would reject the
    container the tuner builds under ``policy``."""
    if (policy.value_dtype not in _CUDA_VALUE_DTYPES
            or getattr(policy, "accum_dtype", "float32") != "float32"):
        return None
    if fmt == "dia":
        # the extent-tightened resident test
        if f.ncols + 2 * f.band_extent <= 4 * policy.resident_cols():
            return "resident"
        return "tiled"
    if fmt == "coo":
        if f.nrows <= policy.max_onehot_rows and f.ncols <= policy.resident_cols():
            return "resident"
        return "tiled" if policy.col_tile(f.ncols) is not None else None
    if fmt == "bsr":
        return "block"
    return "resident" if policy.col_tile(f.ncols) is None else "tiled"


def _affine(c4, krows: float, kentries: float, ratio: float) -> float:
    a, b, c, d = c4
    return a + (b * krows + (c * kentries + d * krows * kentries) * ratio)


def _estimate(f: MatrixFeatures, key: DispatchKey, policy: ExecutionPolicy,
              fitted: bool) -> float:
    table = COST["cpu"] if fitted else COST["cuda"]
    strategy = (cuda_strategy_for(f, policy, key.format) or ""
                if key.backend == "cuda" else "")
    coef = table.get((key.format, key.backend, strategy))
    if coef is None:  # a cell the platform's table does not model
        return float("inf")
    krows = f.nrows / 1e3
    kentries = storage_entries(f, key.format) / 1e3
    ratio = 1.0
    if not fitted:
        base = storage_bytes(f, key.format, _UNCOMPRESSED, strategy)
        ratio = storage_bytes(f, key.format, policy, strategy) / max(base, 1.0)
    est = _affine(coef, krows, kentries, ratio)
    if fitted and strategy == "tiled":
        # column tiling only adds overhead over the resident strategy on the
        # same matrix: floor the fit's tiled estimate at the resident one
        res = table.get((key.format, key.backend, "resident"))
        if res is not None:
            est = max(est, _affine(res, krows, kentries, ratio))
    return est


def estimate_us(f: MatrixFeatures, key: DispatchKey,
                policy: Optional[ExecutionPolicy] = None,
                platform: Optional[str] = None) -> float:
    """The model's time estimate in µs for running SpMV as ``key`` on ``f``.

    On the ``"cuda"`` table the volume terms are scaled by the variant's
    bytes-per-entry ratio against the uncompressed int32+f32 baseline
    (narrow ids and values move fewer bytes). The ``"cpu"`` table describes
    interpreted Pallas, whose time does not track storage width, so it stays
    unscaled, and its tiled estimates are floored at the resident ones, as
    in the reference. The ``"cuda"`` rows are measured lines, one per
    strategy, and take no floor: the resident COO line is drawn through a
    launch-bound call (13^3) and would price the tiled kernel at 104^3 at
    four times its measured time.
    """
    policy = policy if policy is not None else DEFAULT_POLICY
    return _estimate(f, key, policy, fitted=(platform or "cuda") == "cpu")


def rank(a, policy: Optional[ExecutionPolicy] = None,
         candidates: Optional[Sequence] = None,
         platform: Optional[str] = None,
         dia_max_diags: int = DIA_MAX_DIAGS,
         ell_max_width_factor: float = ELL_MAX_WIDTH_FACTOR,
         ) -> List[Prediction]:
    """Rank candidate ``DispatchKey``s for ``a`` without executing anything.

    Args:
        a: a :class:`MatrixFeatures`, or anything ``extract_features``
            accepts (container, operator, scipy, dense).
        policy: execution policy whose column limit picks the ``cuda``
            strategy (default: ``DEFAULT_POLICY``).
        candidates: keys to rank (default ``autotune.DEFAULT_CANDIDATES``);
            structurally infeasible formats, and ``cuda`` keys the predicate
            would reject, are dropped.
        platform: cost-table key (default: :func:`platform_of` ``a``).

    Returns:
        Feasible candidates as :class:`Prediction`s, fastest-estimate first.

    Example:
        >>> import scipy.sparse as sp
        >>> tri = sp.diags([[1.0]*256]*3, [-1, 0, 1], shape=(256, 256))
        >>> rank(tri, platform="cpu")[0].key.format
        'dia'
    """
    platform = platform or platform_of(a)
    f = a if isinstance(a, MatrixFeatures) else extract_features(a)
    policy = policy if policy is not None else DEFAULT_POLICY
    if candidates is None:
        from .autotune import DEFAULT_CANDIDATES

        candidates = DEFAULT_CANDIDATES
    keys = [DispatchKey(fmt, impl) for fmt, impl in candidates]
    out: List[Prediction] = []
    for key in keys:
        if infeasible(f, key.format, dia_max_diags, ell_max_width_factor) is not None:
            continue
        strategy = ""
        if key.backend == "cuda":
            strategy = cuda_strategy_for(f, policy, key.format)
            if strategy is None:
                continue
            if key.format not in ("dia", "bsr", "dense"):
                try:  # a pinned index dtype the tile width cannot hold: the
                    plan_index_dtype(f.ncols, policy)  # build would raise
                except ValueError:
                    continue
        est = estimate_us(f, key, policy, platform)
        reason = (f"{storage_entries(f, key.format):.0f} stored entries"
                  + (f", {strategy}" if strategy else "")
                  + f", {bytes_per_nnz(f, key.format, policy, strategy):.1f} B/nnz")
        out.append(Prediction(key, est, reason))
    out.sort(key=lambda p: (p.est_us, p.key.format, p.key.backend))
    return out


def predict(a, policy: Optional[ExecutionPolicy] = None,
            candidates: Optional[Sequence] = None,
            platform: Optional[str] = None,
            dia_max_diags: int = DIA_MAX_DIAGS,
            ell_max_width_factor: float = ELL_MAX_WIDTH_FACTOR) -> Prediction:
    """Top-1 of :func:`rank`, the zero-run analogue of ``autotune_spmv``.

    Raises:
        RuntimeError: when every candidate is infeasible.
    """
    preds = rank(a, policy=policy, candidates=candidates, platform=platform,
                 dia_max_diags=dia_max_diags,
                 ell_max_width_factor=ell_max_width_factor)
    if not preds:
        raise RuntimeError("format selector: no feasible candidate")
    return preds[0]


def prune_candidates(a, keep: int,
                     policy: Optional[ExecutionPolicy] = None,
                     candidates: Optional[Sequence] = None,
                     platform: Optional[str] = None,
                     dia_max_diags: int = DIA_MAX_DIAGS,
                     ell_max_width_factor: float = ELL_MAX_WIDTH_FACTOR,
                     ) -> List[DispatchKey]:
    """The top-``keep`` predicted candidates, for ``autotune_spmv(prune=k)``."""
    preds = rank(a, policy=policy, candidates=candidates, platform=platform,
                 dia_max_diags=dia_max_diags,
                 ell_max_width_factor=ell_max_width_factor)
    return [p.key for p in preds[:max(1, keep)]]


def selection_drifted(before: MatrixFeatures, after: MatrixFeatures,
                      policy: Optional[ExecutionPolicy] = None,
                      candidates: Optional[Sequence] = None,
                      platform: Optional[str] = None) -> bool:
    """Would the zero-run winner change between two feature snapshots?"""
    a = predict(before, policy=policy, candidates=candidates, platform=platform)
    b = predict(after, policy=policy, candidates=candidates, platform=platform)
    return a.key != b.key


#: package-level spellings
rank_formats = rank
predict_format = predict
