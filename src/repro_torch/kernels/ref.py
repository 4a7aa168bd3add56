"""Torch oracles for the kernels (densify + dense matmul).

Independent of the plain backend in ``repro_torch.core.spmv``: the oracle
goes through ``to_dense`` so a bug shared between the plain and ``cuda``
paths of a format cannot hide. ``dia_spmv_ref`` is the direct Algorithm-3
loop on raw arrays.
"""
from __future__ import annotations

import torch


def _matmul(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def spmv_ref(A, x: torch.Tensor) -> torch.Tensor:
    return _matmul(A.to_dense(), x)


def spmm_ref(A, X: torch.Tensor) -> torch.Tensor:
    return _matmul(A.to_dense(), X)


def dia_spmv_ref(offsets, data, x, shape):
    """Direct Algorithm-3 oracle on raw arrays."""
    nrows, ncols = shape
    i = torch.arange(nrows, device=data.device)
    y = torch.zeros((nrows,), dtype=torch.promote_types(data.dtype, x.dtype),
                    device=data.device)
    for d in range(offsets.shape[0]):
        k = i + offsets[d].long()
        valid = (k >= 0) & (k < ncols)
        y = y + torch.where(valid, data[d] * x[k.clamp(0, ncols - 1)],
                            torch.zeros((), dtype=y.dtype, device=y.device))
    return y


def ell_spmv_ref(indices, data, x):
    valid = indices >= 0
    prod = data * x[torch.where(valid, indices, 0).long()]
    return torch.where(valid, prod, torch.zeros((), dtype=prod.dtype)).sum(dim=1)


def coo_spmv_ref(row, col, val, x, nrows):
    prod = val * x[col.long()]
    y = torch.zeros((nrows + 1,), dtype=prod.dtype, device=prod.device)
    y.index_put_((row.long().clamp(max=nrows),), prod, accumulate=True)
    return y[:nrows]


def bsr_spmm_ref(bcols, blocks, X):
    """(nbr,w,bs,bs) blocks x (nbcols*bs, nf) dense -> (nbr*bs, nf)."""
    nbr, w, bs, _ = blocks.shape
    nf = X.shape[1]
    Xb = X.reshape(-1, bs, nf)
    valid = (bcols >= 0)[..., None, None]
    Xg = torch.where(valid, Xb[torch.where(bcols >= 0, bcols, 0).long()],
                     torch.zeros((), dtype=X.dtype))
    return torch.einsum("rwij,rwjf->rif", blocks, Xg).reshape(nbr * bs, nf)
