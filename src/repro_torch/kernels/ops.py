"""The ``cuda`` backend: the hand-written kernels registered into the
dispatch table, with the reference's capability predicates.

The predicates and the strategy choice are those of
``repro.kernels.ops`` (``pallas`` renamed ``cuda``), so for the same matrix
and policy both packages pick the same strategy:

  - **resident**: the kernel reads x whole; chosen when the format's
    columns fit ``policy.resident_cols()``;
  - **column-tiled**: the kernel walks the convert-time
    :class:`~repro_torch.core.formats.KernelPlan`'s column tiles.

``csr`` and ``sell`` both run ``scs_spmv`` over their ``"scs"`` plan; ``dia``
runs ``dia_spmv`` or ``dia_spmv_tiled``. ell, coo and bsr register no
``cuda`` entry yet (ROADMAP queue 2), so the tuner lists them as
"impl not registered".
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import CSR, DIA, SELL
from repro_torch.core.spmv import register_masked_spmv, register_spmv

from .dia_spmv import dia_spmv, dia_spmv_tiled
from .sell_spmv import scs_spmv_from_plan

# --------------------------------------------------- capability predicates ----

#: Value dtypes the kernels take: each upcasts products to f32 before
#: reducing; f64 is left to the plain/dense backends.
_CUDA_VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _precision_ok(A, policy) -> bool:
    """f32 accumulation (the only mode the kernels implement) over a storage
    dtype they can upcast from."""
    accum = getattr(policy, "accum_dtype", "float32")
    return accum == "float32" and A.dtype in _CUDA_VALUE_DTYPES


def _plan_ok(A, policy, kind: str) -> bool:
    """A column-tile plan of ``kind`` whose tile fits the policy's limit."""
    p = A.plan
    return p is not None and p.kind == kind and p.ct <= policy.resident_cols()


def _dia_extent(A: DIA) -> int:
    """``max|offset|``: the bound ``to_dia`` records, else read from the
    offsets."""
    if A.extent is not None:
        return int(A.extent)
    return int(A.offsets.abs().max()) if A.offsets.numel() else 0


def _dia_resident(A: DIA, policy) -> bool:
    # the reference's fit rule: x plus the band's padding on both sides
    return A.shape[1] + 2 * _dia_extent(A) <= 4 * policy.resident_cols()


def _dia_ok(A: DIA, policy) -> bool:
    return _precision_ok(A, policy) and (
        _dia_resident(A, policy) or _plan_ok(A, policy, "dia-cols"))


def _scs_ok(A, policy) -> bool:
    return _precision_ok(A, policy) and _plan_ok(A, policy, "scs")


def cuda_strategy(A, policy) -> str | None:
    """Which strategy dispatch would run for ``A`` under ``policy``:
    ``"resident"``, ``"tiled"``, or ``None`` (the predicate rejects). The
    twin of the reference's ``pallas_strategy``; formats without a ``cuda``
    kernel yet answer as the reference does, for the comparison."""
    fmt = A.format
    if not _precision_ok(A, policy):
        return None
    if fmt == "dia":
        if _dia_resident(A, policy):
            return "resident"
        return "tiled" if _plan_ok(A, policy, "dia-cols") else None
    if fmt == "ell":
        if A.shape[1] <= policy.resident_cols():
            return "resident"
        return "tiled" if _plan_ok(A, policy, "ell-cols") else None
    if fmt == "coo":
        if A.shape[0] <= policy.max_onehot_rows and A.shape[1] <= policy.resident_cols():
            return "resident"
        return "tiled" if _plan_ok(A, policy, "coo-cols") else None
    if fmt in ("csr", "sell"):
        if not _scs_ok(A, policy):
            return None
        return "tiled" if A.plan.ntiles > 1 else "resident"
    if fmt == "bsr":
        return "block"
    return None


# ------------------------------------------------------------ registrations ----


def _dia_tiled(A: DIA, x, mask=None):
    plan = A.plan
    offs_t, dat_w = plan.arrays
    rng = None
    if dat_w.device.type != "cpu":
        rng = plan.cache.get("offset_range")
        if rng is None:
            rng = plan.cache["offset_range"] = (int(offs_t.min()), int(offs_t.max()))
    return dia_spmv_tiled(offs_t, dat_w, x, nrows=A.shape[0], col_tile=plan.ct,
                          mask=mask, offset_range=rng)


@register_spmv("dia", "cuda", supports=_dia_ok, needs_policy=True)
def dia_spmv_cuda(A: DIA, x, policy):
    if cuda_strategy(A, policy) == "resident":
        return dia_spmv(A.offsets, A.data, x)
    return _dia_tiled(A, x)


@register_spmv("sell", "cuda", supports=_scs_ok)
def sell_spmv_cuda(A: SELL, x):
    """SELL-C-σ kernel over the convert-time ``"scs"`` stream."""
    return scs_spmv_from_plan(A.plan, x, nrows=A.shape[0])


@register_spmv("csr", "cuda", supports=_scs_ok)
def csr_spmv_cuda(A: CSR, x):
    """CSR runs the same SELL-C-σ kernel through its cached SCS view."""
    return scs_spmv_from_plan(A.plan, x, nrows=A.shape[0])


@register_masked_spmv("dia", "cuda", supports=_dia_ok, needs_policy=True)
def dia_masked_spmv_cuda(A: DIA, x, row_mask, policy):
    """One multicolor SymGS color: the row mask goes into the kernel, which
    skips the rows outside it and writes 0 there — no masked copy of
    ``data`` (121 MB per color at HPCG 104^3). Equal to
    ``where(row_mask, A @ x, 0)``."""
    if cuda_strategy(A, policy) == "resident":
        return dia_spmv(A.offsets, A.data, x, mask=row_mask)
    return _dia_tiled(A, x, mask=row_mask)
