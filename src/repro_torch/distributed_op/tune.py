"""Per-partition run-first auto-tuning (paper §VII-D, Table III).

The paper's distributed HPCG runs the auto-tuner *on every process*: each
rank times the candidate formats on its own local and remote sub-matrices
and keeps its own winner (the SVE build lands on DIA-local + COO-remote).
Here each part's blocks are tuned with the single-device ``autotune_spmv``
on that part's device — the run-first measurement a rank would make — and
the winners are assembled into one ``DistributedOperator`` whose format
groups hold the per-part choices. The PyTorch counterpart of
``repro.distributed_op.tune``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.autotune import autotune_spmv
from repro_torch.core.convert import _as_scipy
from repro_torch.core.distributed import PartMesh, mesh_parts, split_local_remote
from repro_torch.core.operator import ExecutionPolicy
from repro_torch.core.spmv import DispatchKey

from .operator import STACKABLE_FORMATS, DistributedOperator

#: Default distributed candidates: every stackable format on the plain
#: backend. ``cuda`` candidates can be passed explicitly — note that the
#: operator's part containers carry no ``KernelPlan`` (``build_stacked``
#: disables them, as the reference's stacking does), so a ``cuda`` kernel
#: that needs one (csr, and coo above ``max_onehot_rows`` rows) runs the
#: group's next backend, plain, even if it won the race on the unstacked
#: block, which carries its plan; the resident dia/ell/coo kernels run as
#: raced.
DISTRIBUTED_CANDIDATES: Tuple[DispatchKey, ...] = (
    DispatchKey("csr", "plain"),
    DispatchKey("dia", "plain"),
    DispatchKey("ell", "plain"),
    DispatchKey("coo", "plain"),
)

_EMPTY_CHOICE = DispatchKey("coo", "plain")  # cheapest container for nnz=0


def _stackable(candidates) -> Tuple[DispatchKey, ...]:
    keys = tuple(DispatchKey(f, b) for f, b in candidates)
    kept = tuple(k for k in keys if k.format in STACKABLE_FORMATS)
    if not kept:
        raise ValueError(f"no stackable candidate in {keys}; distributed "
                         f"containers must be one of {STACKABLE_FORMATS}")
    return kept


def tune_partitions(
    a,
    mesh: PartMesh,
    axis: str = "data",
    candidates: Optional[Sequence] = None,
    mode: str = "auto",
    iters: int = 5,
    warmup: int = 2,
    policy: Optional[ExecutionPolicy] = None,
    dtype=torch.float32,
) -> Tuple[DistributedOperator, Dict]:
    """Tune every part's local and remote block independently.

    Args:
        a: the global matrix (anything ``as_operator`` accepts).
        mesh / axis: the 1-D mesh of parts rows will be partitioned over.
        candidates: ``DispatchKey``s (or ``(fmt, backend)`` pairs) to race;
            non-stackable formats (sell/bsr) are filtered out. Defaults to
            :data:`DISTRIBUTED_CANDIDATES`.
        mode: halo mode for the built operator (``"auto"``/``"halo"``/
            ``"allgather"``); the tuner always times the split blocks.
        iters / warmup: per-candidate timing repetitions.
        policy: base ``ExecutionPolicy`` limits the candidates run under.
        dtype: value dtype of the built containers.

    Returns:
        ``(op, table)`` — the :class:`DistributedOperator` whose per-part
        choices are the tuning winners, and a table mapping
        ``(part, "local"|"remote")`` to that block's ``{(fmt, backend): us}``
        timings (empty remote blocks are assigned ``coo/plain`` unraced).

    Example::

        op, table = tune_partitions(M.fdm27(4, 4, 4), PartMesh.on("cpu", parts=1))
        y = op @ op.device_put(np.ones(64))
    """
    s = _as_scipy(a).tocsr()
    nparts = mesh_parts(mesh, axis)
    cand = _stackable(candidates if candidates is not None
                      else DISTRIBUTED_CANDIDATES)
    locals_, remotes, _ = split_local_remote(
        s, nparts, halo=None if mode == "allgather" else "auto")

    lkeys, rkeys, table = [], [], {}
    for p, dev in enumerate(mesh.devices):
        res = autotune_spmv(locals_[p], candidates=cand, iters=iters,
                            warmup=warmup, policy=policy, dtype=dtype, device=dev)
        lkeys.append(res.key)
        table[(p, "local")] = res.table
        if remotes[p].nnz == 0:
            rkeys.append(_EMPTY_CHOICE)
            continue
        res = autotune_spmv(remotes[p], candidates=cand, iters=iters,
                            warmup=warmup, policy=policy, dtype=dtype, device=dev)
        rkeys.append(res.key)
        table[(p, "remote")] = res.table

    op = DistributedOperator.build(s, mesh, axis, local=tuple(lkeys),
                                   remote=tuple(rkeys), mode=mode,
                                   policy=policy, dtype=dtype)
    return op, table
