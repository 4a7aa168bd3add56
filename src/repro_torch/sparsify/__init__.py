"""Bridge between the sparse library and the LM stack: the port of
``repro.sparsify``.

- MoE dispatch-as-SpMM with a switchable implementation lives in
  ``repro_torch.models.moe`` (``moe_ffn`` is re-exported here).
- ``prune_linear_to_bsr`` turns a dense weight into a BSR container
  (magnitude pruning at block granularity), with the reference's blocks,
  ``bcols`` and threshold exactly; ``bsr_linear`` applies it through the
  SpMM dispatch (the ``bsr_spmm`` kernel on ``cuda``).
- ``prune_step`` deletes the smallest entries through a ``DeltaOverlay``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import BSR, resolve_device
from repro_torch.core.spmv import spmm
from repro_torch.models.moe import moe_ffn  # noqa: F401  (dispatch impls)


def prune_linear_to_bsr(w, density: float = 0.25, bs: int = 32, device="cuda") -> BSR:
    """Keep the top-``density`` fraction of (bs x bs) blocks of w (in, out)
    by Frobenius norm; returns a BSR container over w^T (out, in) on
    ``device``, so that ``y = W_bsr @ x`` matches ``x @ w``. The blocks are
    chosen on the host in f32, as the reference chooses them."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32).T                        # (out, in)
    out_d, in_d = w.shape
    nbr, nbc = -(-out_d // bs), -(-in_d // bs)
    pad = np.zeros((nbr * bs, nbc * bs), np.float32)
    pad[:out_d, :in_d] = w
    blocks = pad.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)  # (nbr,nbc,bs,bs)
    norms = np.linalg.norm(blocks, axis=(2, 3))
    k = max(1, int(density * nbr * nbc))
    thresh = np.partition(norms.reshape(-1), -k)[-k]
    keep = norms >= thresh
    bwidth = max(1, int(keep.sum(axis=1).max()))
    bcols = np.full((nbr, bwidth), -1, np.int32)
    bdata = np.zeros((nbr, bwidth, bs, bs), np.float32)
    for r in range(nbr):
        cols = np.nonzero(keep[r])[0][:bwidth]
        bcols[r, : len(cols)] = cols
        bdata[r, : len(cols)] = blocks[r, cols]
    dev = resolve_device(device)
    return BSR(torch.from_numpy(bcols).to(dev), torch.from_numpy(bdata).to(dev),
               (out_d, in_d))


def bsr_linear(A: BSR, x, impl: str = "cuda"):
    """y = x @ W for the pruned weight (A built over W^T): (..., in) -> (..., out)."""
    lead = x.shape[:-1]
    X = x.reshape(-1, x.shape[-1]).T                       # (in, batch)
    Y = spmm(A, X, impl)                                   # (out, batch)
    return Y.T.reshape(*lead, A.shape[0])


def prune_step(overlay, fraction: float = 0.1) -> int:
    """One magnitude-pruning sweep through the mutation lane: delete the
    smallest-|value| ``fraction`` of the matrix's current logical nonzeros
    via ``overlay.delete``. Returns the number of entries deleted. Ties
    break on (row, col) order via the canonical CSR merge."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"prune_step: fraction must be in (0, 1], got {fraction}")
    s = overlay.to_scipy().tocoo()
    if s.nnz == 0:
        return 0
    k = max(1, int(fraction * s.nnz))
    order = np.argsort(np.abs(s.data), kind="stable")[:k]
    for i, j in zip(s.row[order].tolist(), s.col[order].tolist()):
        overlay.delete(int(i), int(j))
    return int(order.shape[0])
