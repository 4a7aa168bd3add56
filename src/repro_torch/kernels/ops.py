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
runs ``dia_spmv`` or ``dia_spmv_tiled``, ``ell`` runs ``ell_spmv`` or
``ell_spmv_tiled``, ``coo`` runs ``coo_spmv`` or ``scoo_spmv_tiled``, and
``bsr`` runs ``bsr_spmm`` for SpMM, SpMV (the SpMM of one column) and masked
SpMV, for the block edges the kernel is built for (8, 16, 32, 64). dia, ell
and bsr carry the row mask into their kernels; masked COO runs the ``coo``
kernel and masks after it (the dispatch's same-backend path).
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import BSR, COO, CSR, DIA, ELL, SELL
from repro_torch.core.spmv import register_masked_spmv, register_spmm, register_spmv

from ._launch import segment_starts
from .bsr_spmm import BLOCK_SIZES, bsr_spmm
from .coo_spmv import coo_spmv_from_container, scoo_spmv_tiled
from .dia_spmv import dia_spmv_from_container, dia_spmv_tiled_from_plan
from .ell_spmv import ell_spmv, ell_spmv_tiled, ell_tile_index
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
    offsets once and kept in ``A.cache`` (a later call, such as one inside a
    CUDA graph capture, reads nothing)."""
    if A.extent is not None:
        return int(A.extent)
    if "extent" not in A.cache:
        A.cache["extent"] = int(A.offsets.abs().max()) if A.offsets.numel() else 0
    return A.cache["extent"]


def _dia_resident(A: DIA, policy) -> bool:
    # the reference's fit rule: x plus the band's padding on both sides
    return A.shape[1] + 2 * _dia_extent(A) <= 4 * policy.resident_cols()


def _dia_ok(A: DIA, policy) -> bool:
    return _precision_ok(A, policy) and (
        _dia_resident(A, policy) or _plan_ok(A, policy, "dia-cols"))


def _ell_resident(A: ELL, policy) -> bool:
    return A.shape[1] <= policy.resident_cols()


def _ell_ok(A: ELL, policy) -> bool:
    return _precision_ok(A, policy) and (
        _ell_resident(A, policy) or _plan_ok(A, policy, "ell-cols"))


def _coo_resident(A: COO, policy) -> bool:
    # the reference's full-window limits, kept for parity: on the card no
    # one-hot window exists, but the same matrices take the same strategy
    return (A.shape[0] <= policy.max_onehot_rows
            and A.shape[1] <= policy.resident_cols())


def _coo_ok(A: COO, policy) -> bool:
    return _precision_ok(A, policy) and (
        _coo_resident(A, policy) or _plan_ok(A, policy, "coo-cols"))


def _scs_ok(A, policy) -> bool:
    return _precision_ok(A, policy) and _plan_ok(A, policy, "scs")


def _bsr_ok(A: BSR, policy) -> bool:
    return _precision_ok(A, policy) and A.bs in BLOCK_SIZES


def cuda_strategy(A, policy) -> str | None:
    """Which strategy dispatch would run for ``A`` under ``policy``:
    ``"resident"``, ``"tiled"``, or ``None`` (the predicate rejects). The
    twin of the reference's ``pallas_strategy``; bsr has one strategy, the
    block walk, for the block edges the kernel takes."""
    fmt = A.format
    if not _precision_ok(A, policy):
        return None
    if fmt == "dia":
        if _dia_resident(A, policy):
            return "resident"
        return "tiled" if _plan_ok(A, policy, "dia-cols") else None
    if fmt == "ell":
        if _ell_resident(A, policy):
            return "resident"
        return "tiled" if _plan_ok(A, policy, "ell-cols") else None
    if fmt == "coo":
        if _coo_resident(A, policy):
            return "resident"
        return "tiled" if _plan_ok(A, policy, "coo-cols") else None
    if fmt in ("csr", "sell"):
        if not _scs_ok(A, policy):
            return None
        return "tiled" if A.plan.ntiles > 1 else "resident"
    if fmt == "bsr":
        return "block" if A.bs in BLOCK_SIZES else None
    return None


# ------------------------------------------------------------ registrations ----


def _cached(cache: dict, key: str, make):
    """``cache[key]``, made once: what a kernel derives from a container or
    its plan (segment starts, tile index) is computed at its first call and
    kept in the container's or the plan's ``cache``."""
    value = cache.get(key)
    if value is None:
        value = cache[key] = make()
    return value


@register_spmv("dia", "cuda", supports=_dia_ok, needs_policy=True)
def dia_spmv_cuda(A: DIA, x, policy):
    if cuda_strategy(A, policy) == "resident":
        return dia_spmv_from_container(A, x)
    return dia_spmv_tiled_from_plan(A.plan, x, A.shape[0])


@register_spmv("ell", "cuda", supports=_ell_ok, needs_policy=True)
def ell_spmv_cuda(A: ELL, x, policy, mask=None):
    if cuda_strategy(A, policy) == "resident":
        listed = None
        if A.data.device.type != "cpu":
            listed = _cached(A.cache, "tile_index",
                             lambda: ell_tile_index(A.indices.unsqueeze(0)))
        return ell_spmv(A.indices, A.data, x, mask=mask, tile_index=listed)
    plan = A.plan
    idx_t, dat_t = plan.arrays
    listed = None
    if dat_t.device.type != "cpu":
        listed = _cached(plan.cache, "tile_index", lambda: ell_tile_index(idx_t))
    return ell_spmv_tiled(idx_t, dat_t, x, col_tile=plan.ct, mask=mask, tile_index=listed)


@register_spmv("coo", "cuda", supports=_coo_ok, needs_policy=True)
def coo_spmv_cuda(A: COO, x, policy):
    """Full window for the matrices the reference keeps whole (the
    container checked once, its row segment starts cached on it), else the
    sliced kernel over the ``"coo-cols"`` plan (slice block runs cached on
    the plan)."""
    if cuda_strategy(A, policy) == "resident":
        return coo_spmv_from_container(A, x)
    on_card = A.val.device.type != "cpu"
    plan = A.plan
    row, col, val, sid, ctile = plan.arrays
    ct, _, slice_rows, tile = (int(v) for v in plan.meta)
    runs = None
    if on_card:
        nslices = -(-A.shape[0] // slice_rows)
        runs = _cached(plan.cache, "run_start", lambda: segment_starts(sid, nslices))
    return scoo_spmv_tiled(row, col, val, sid, ctile, x, nrows=A.shape[0], col_tile=ct,
                           slice_rows=slice_rows, tile=tile, run_start=runs)


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
        return dia_spmv_from_container(A, x, row_mask)
    return dia_spmv_tiled_from_plan(A.plan, x, A.shape[0], row_mask)


@register_masked_spmv("ell", "cuda", supports=_ell_ok, needs_policy=True)
def ell_masked_spmv_cuda(A: ELL, x, row_mask, policy):
    """The row mask goes into the ELL kernels as it does into DIA's: masked
    rows load nothing and are 0. Equal to ``where(row_mask, A @ x, 0)``."""
    return ell_spmv_cuda(A, x, policy, mask=row_mask)


@register_spmm("bsr", "cuda", supports=_bsr_ok)
def bsr_spmm_cuda(A: BSR, X):
    """Y = A @ X through ``bsr_spmm``; rows past ``A.shape[0]`` cut, Y in
    X's dtype (as the reference's ``bsr_spmm_pallas``)."""
    return bsr_spmm(A.bcols, A.blocks, X)[: A.shape[0]].to(X.dtype)


@register_spmv("bsr", "cuda", supports=_bsr_ok)
def bsr_spmv_cuda(A: BSR, x):
    return bsr_spmm_cuda(A, x[:, None])[:, 0]


@register_masked_spmv("bsr", "cuda", supports=_bsr_ok)
def bsr_masked_spmv_cuda(A: BSR, x, row_mask):
    """The row mask goes into the kernel, padded to whole block rows:
    masked rows load nothing and are 0, the others equal the unmasked
    SpMV bit for bit — no masked copy of the blocks. Equal to
    ``where(row_mask, A @ x, 0)``."""
    nrows = A.shape[0]
    m = torch.zeros(A.bcols.shape[0] * A.bs, dtype=torch.bool, device=row_mask.device)
    m[:nrows] = row_mask
    Y = bsr_spmm(A.bcols, A.blocks, x[:, None], row_mask=m)
    return Y[:nrows, 0].to(x.dtype)
