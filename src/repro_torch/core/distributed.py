"""Distributed SpMV with a local/remote format split (paper §VII-D, Table III).

The paper's distributed HPCG partitions matrix rows across MPI ranks and
*physically splits* each rank's rows into a structured **local** block
(columns the rank owns) and an unstructured **remote** block (halo columns),
choosing a storage format for each independently via the run-first
auto-tuner — landing on DIA(local) + COO(remote) for the SVE version.

The PyTorch counterpart of ``repro.core.distributed``. The reference drives
every device of a ``jax.sharding.Mesh`` from one process through
``shard_map``; here one process drives a :class:`PartMesh` — a 1-D tuple of
``torch.device``s under one axis name — with a loop over its parts:

  - row partition  -> one container per part, on that part's device (no
                      stacking: nothing consumes a stacked leaf)
  - MPI halo recv  -> the ``halo``-wide boundary slices of the neighbouring
                      parts' x, moved with ``.to(part_device)``
                      (:func:`halo_window`), or
    MPI allgather  -> the whole x moved to the part's device
                      (:func:`halo_window` with ``halo=None``)
  - the per-rank program -> :func:`run_parts`, part outputs concatenated on
                      the home device

Vectors are global tensors on the mesh's *home* device (its first). Several
parts may share one device (``PartMesh.on("cuda", parts=4)`` on one card):
the split, the per-part kernels and the halo windows all run there.

The host-side split is vectorised over COO masks; its arrays equal the
reference's ``tolil``-based split (far too slow at HPCG sizes).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from .convert import to_coo, to_csr, to_dia, to_ell
from .formats import COO, CSR, DIA, resolve_device, to_tensor
from .operator import ExecutionPolicy, policy_for_impl
from .spmv import spmv

# ----------------------------------------------------------------- mesh ----


@dataclass(frozen=True)
class PartMesh:
    """A 1-D mesh of parts: ``devices[p]`` holds part ``p``.

    The port's stand-in for a 1-D ``jax.sharding.Mesh``: ``mesh.shape[axis]``
    is the part count, ``home`` (the first device) holds the global vectors.

    Example:
        >>> mesh = PartMesh.on("cpu", parts=4)
        >>> mesh.shape["data"], str(mesh.home)
        (4, 'cpu')
    """

    devices: Tuple[torch.device, ...]
    axis: str = "data"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a PartMesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_indexed(d) for d in self.devices))

    @classmethod
    def on(cls, device="cuda", parts: int = 1, axis: str = "data") -> "PartMesh":
        """``parts`` parts all on one ``device`` (raises for ``"cuda"``
        without a card, as ``resolve_device`` does)."""
        if parts <= 0:
            raise ValueError(f"parts must be positive, got {parts}")
        dev = _indexed(device)
        return cls((dev,) * parts, axis)

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def mesh_parts(mesh: PartMesh, axis: str) -> int:
    """``mesh.shape[axis]``, refusing an axis the mesh does not have."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has axis {mesh.axis!r}, not {axis!r}")
    return int(mesh.shape[axis])


def _indexed(device) -> torch.device:
    """``device`` resolved, a CUDA device with its index (``"cuda"`` is the
    current card), so that it compares equal to a tensor's ``.device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class PartRows(NamedTuple):
    """Where part ``p``'s rows of a distributed vector live:
    ``[r0, r1)`` of the global vector, computed on ``device``."""

    device: torch.device
    r0: int
    r1: int


# ------------------------------------------------------------ splitting ----

def partition_rows(n: int, nparts: int, even: bool = True) -> List[Tuple[int, int]]:
    """Contiguous row ranges ``[(r0, r1), ...]`` assigning ``n`` rows to
    ``nparts`` parts.

    Args:
        n: total number of rows (>= 0).
        nparts: number of partitions (> 0).
        even: with the default ``True``, every part must get exactly
            ``n // nparts`` rows (every part's container has one shape) and
            a non-dividing ``n`` raises ``ValueError`` (pad upstream, or
            pass ``even=False``). With ``even=False`` the split is
            HPCG-style balanced: the first ``n % nparts`` parts get one
            extra row, and parts beyond ``n`` rows come back empty
            (``r0 == r1``), so ``nparts > n`` is legal.

    Returns:
        A list of ``nparts`` half-open ``(r0, r1)`` ranges covering ``[0, n)``
        in order.

    Example:
        >>> partition_rows(8, 4)
        [(0, 2), (2, 4), (4, 6), (6, 8)]
        >>> partition_rows(7, 3, even=False)
        [(0, 3), (3, 5), (5, 7)]
    """
    if nparts <= 0:
        raise ValueError(f"nparts must be positive, got {nparts}")
    if n < 0:
        raise ValueError(f"row count must be non-negative, got {n}")
    if even:
        if n % nparts != 0:
            raise ValueError(
                f"rows {n} must be divisible by {nparts} parts for an even "
                f"partition (pad upstream, or pass even=False for a "
                f"balanced one)")
        m = n // nparts
        return [(p * m, (p + 1) * m) for p in range(nparts)]
    base, extra = divmod(n, nparts)
    bounds = [0]
    for p in range(nparts):
        bounds.append(bounds[-1] + base + (1 if p < extra else 0))
    return [(bounds[p], bounds[p + 1]) for p in range(nparts)]


def _entry_rows(s: sp.csr_matrix) -> np.ndarray:
    """Row of every stored entry of a CSR matrix, in storage order."""
    return np.repeat(np.arange(s.shape[0], dtype=np.int64), np.diff(s.indptr))


def _max_reach(s: sp.spmatrix, nparts: int) -> int:
    """How far any entry lies outside its row part's own column range
    (explicit zeros included): the smallest halo that covers every remote
    entry."""
    s = s.tocsr()
    nr, nc = s.shape
    partition_rows(nr, nparts)
    partition_rows(nc, nparts)
    if s.nnz == 0:
        return 0
    mr, mc = nr // nparts, nc // nparts
    c0 = (_entry_rows(s) // mr) * mc
    col = s.indices.astype(np.int64)
    return int(np.maximum(np.maximum(c0 - col, col - (c0 + mc - 1)), 0).max())


def split_local_remote(s: sp.spmatrix, nparts: int, halo="auto"):
    """Split ``s`` into per-part **local** (own columns) and **remote**
    matrices — the physical split of the paper's distributed HPCG (§VII-D).

    Rows are partitioned evenly into ``nparts`` blocks of ``mr`` rows;
    columns into blocks of ``mc`` (for the square matrices of SpMV
    ``mr == mc``; rectangular matrices such as multigrid restriction /
    prolongation maps are partitioned along both axes independently, so
    both dims must be divisible by ``nparts``). Part ``p``'s local matrix is
    its ``(mr, mc)`` own-column block; everything else lands in its remote
    matrix.

    Args:
        s: scipy sparse matrix, ``(nr, nc)`` with ``nr % nparts == 0`` and
            ``nc % nparts == 0``.
        nparts: number of row partitions.
        halo: ``"auto"`` measures the maximum column reach of any remote
            entry and uses window coordinates when a finite halo covers it;
            ``None`` forces global-coordinate remotes (the allgather path);
            an ``int`` forces that window half-width.

    Returns:
        ``(locals, remotes, halo)`` as ``repro.core.distributed``'s, array
        for array. ``locals[p]`` is ``(mr, mc)``, its entries in ``s``'s
        storage order (explicit zeros and duplicates kept, as scipy's column
        slice keeps them). ``remotes[p]`` is canonical CSR (duplicates
        summed, zeros dropped): ``(mr, mc + 2*halo)`` in *window*
        coordinates — part ``p``'s own column range extended by ``halo`` on
        both sides — when the returned ``halo`` is an int, else
        ``(mr, nc)`` in global coordinates.
    """
    s = s.tocsr()
    nr, nc = s.shape
    parts = partition_rows(nr, nparts)
    partition_rows(nc, nparts)
    mc = nc // nparts
    if halo == "auto":
        reach = _max_reach(s, nparts)
        halo = reach if reach <= mc else None

    rows = _entry_rows(s)
    cols = s.indices.astype(np.int64)
    locals_, remotes = [], []
    for p, (r0, r1) in enumerate(parts):
        mr = r1 - r0
        c0 = p * mc
        lo, hi = int(s.indptr[r0]), int(s.indptr[r1])
        row, col, val = rows[lo:hi] - r0, cols[lo:hi], s.data[lo:hi]
        own = (col >= c0) & (col < c0 + mc)
        counts = np.bincount(row[own], minlength=mr)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        locals_.append(sp.csr_matrix(
            (val[own], (col[own] - c0).astype(np.int32), indptr), shape=(mr, mc)))
        rrow, rcol, rval = row[~own], col[~own], val[~own]
        if halo is None:
            shape = (mr, nc)
        else:
            rcol = rcol - (c0 - halo)
            shape = (mr, mc + 2 * halo)
            if rcol.size and (rcol.min() < 0 or rcol.max() >= shape[1]):
                raise ValueError("halo window does not cover remote entries")
        rem = sp.coo_matrix((rval, (rrow, rcol)), shape=shape).tocsr()
        rem.eliminate_zeros()
        remotes.append(rem)
    return locals_, remotes, halo


def split_rowblocks(s: sp.spmatrix, nparts: int) -> List[sp.csr_matrix]:
    """Per-part full row blocks ``s[r0:r1, :]`` — **no** column split.

    The exact-arithmetic layout: every row keeps all its entries in the
    global CSR order, so a per-part plain-CSR SpMV against the whole x
    accumulates each row in exactly the same order as the single-device
    kernel — the bit-for-bit validation mode of the distributed pipeline
    (``DistributedOperator`` ``mode="rowblock"``).
    """
    s = s.tocsr()
    return [s[r0:r1] for r0, r1 in partition_rows(s.shape[0], nparts)]


# ------------------------------------------------------ part containers ----

Devices = Union[str, torch.device, Sequence[Union[str, torch.device]]]


def _part_devices(devices: Devices, nparts: int) -> Tuple[torch.device, ...]:
    if isinstance(devices, (str, torch.device)):
        return (_indexed(devices),) * nparts
    devs = tuple(_indexed(d) for d in devices)
    if len(devs) != nparts:
        raise ValueError(f"need one device per part: got {len(devs)} for {nparts}")
    return devs


def build_stacked(mats: Sequence[sp.spmatrix], fmt: str, dtype=torch.float32,
                  device: Devices = "cuda") -> Tuple:
    """Convert each part to ``fmt`` with the reference's common padded
    sizes: one container per part, part ``p`` on ``device[p]`` (or all on
    one ``device``).

    Part ``p``'s arrays equal ``repro.core.distributed.build_stacked``'s
    stacked leaves ``[p]``: COO and CSR padded to the largest part's entry
    count, DIA to its diagonal count with one shared ``extent``, ELL at one
    width. Column-tile ``KernelPlan``s are disabled (``col_tile=False``,
    ``plan=False``) as the reference disables them, so a part's
    ``(fmt, "cuda")`` choice that needs a plan (csr, and coo above
    ``max_onehot_rows``) runs the next backend of its group's policy chain.
    """
    mats = [m.tocsr() for m in mats]
    devs = _part_devices(device, len(mats))
    if fmt == "coo":
        nnz = max(1, max(int(m.nnz) for m in mats))
        cs = [_pad_coo(to_coo(m, dtype=dtype, col_tile=False, device=d), nnz)
              for m, d in zip(mats, devs)]
    elif fmt == "csr":
        nnz = max(1, max(int(m.nnz) for m in mats))
        cs = [_pad_csr(to_csr(m, dtype=dtype, plan=False, device=d), nnz)
              for m, d in zip(mats, devs)]
    elif fmt == "dia":
        cs = [to_dia(m, dtype=dtype, col_tile=False, device=d) for m, d in zip(mats, devs)]
        nd = max(c.ndiags for c in cs)
        # the reference stacks one static extent: the max across parts, a
        # valid (if loose) bound for each
        ext = max((c.extent or 0) for c in cs)
        cs = [replace(_pad_dia(c, nd), extent=ext) for c in cs]
    elif fmt == "ell":
        w = max(1, max(int(np.diff(m.indptr).max() if m.nnz else 1) for m in mats))
        cs = [to_ell(m, dtype=dtype, width=w, col_tile=False, device=d)
              for m, d in zip(mats, devs)]
    else:
        raise ValueError(f"unsupported distributed format {fmt!r}")
    return tuple(cs)


def _pad_coo(c: COO, nnz: int) -> COO:
    pad = nnz - c.row.shape[0]
    if pad <= 0:
        return c
    dev = c.row.device
    return COO(
        torch.cat([c.row, torch.full((pad,), c.shape[0], dtype=torch.int32, device=dev)]),
        torch.cat([c.col, torch.zeros((pad,), dtype=torch.int32, device=dev)]),
        torch.cat([c.val, torch.zeros((pad,), dtype=c.val.dtype, device=dev)]),
        c.shape,
    )


def _pad_csr(c: CSR, nnz: int) -> CSR:
    pad = nnz - c.data.shape[0]
    if pad <= 0:
        return c
    dev = c.data.device
    return CSR(
        c.indptr,
        torch.cat([c.indices, torch.zeros((pad,), dtype=torch.int32, device=dev)]),
        torch.cat([c.data, torch.zeros((pad,), dtype=c.data.dtype, device=dev)]),
        c.shape,
    )


def _pad_dia(c: DIA, nd: int) -> DIA:
    pad = nd - c.ndiags
    if pad <= 0:
        return c
    dev = c.data.device
    return DIA(
        torch.cat([c.offsets, torch.zeros((pad,), dtype=torch.int32, device=dev)]),
        torch.cat([c.data, torch.zeros((pad, c.data.shape[1]), dtype=c.data.dtype,
                                       device=dev)]),
        c.shape, extent=c.extent,
    )


# ------------------------------------------------------------- exchange ----

def halo_window(x: torch.Tensor, p: int, nparts: int, halo: Optional[int],
                device: torch.device) -> torch.Tensor:
    """Part ``p``'s window of the global vector ``x`` on ``device``: the
    left neighbour's last ``halo`` entries, the part's own shard, the right
    neighbour's first ``halo`` (zeros past the two ends: the boundaries are
    not periodic) — HPCG's nearest-neighbour exchange, each slice moved
    from where it lives to the part's device. ``halo=None`` is the
    allgather exchange: the whole x."""
    if halo is None:
        return x.to(device)
    m = x.shape[0] // nparts
    own = x[p * m:(p + 1) * m].to(device)
    if halo == 0:
        return own
    z = torch.zeros((halo,), dtype=x.dtype, device=device)
    lo = x[p * m - halo:p * m].to(device) if p > 0 else z
    hi = x[(p + 1) * m:(p + 1) * m + halo].to(device) if p < nparts - 1 else z
    return torch.cat([lo, own, hi])


def run_parts(mesh: PartMesh, part: Callable[[int, torch.device], torch.Tensor]) -> torch.Tensor:
    """The one controller's per-part program: ``part(p, device)`` for every
    part in order, the outputs concatenated on the mesh's home device."""
    return torch.cat([part(p, dev).to(mesh.home) for p, dev in enumerate(mesh.devices)])


# --------------------------------------------------------------- operator ----

@dataclass
class DistributedSpMV:
    """y = A @ x over a :class:`PartMesh` with split local/remote formats.

    ``local_fmt``/``remote_fmt`` default to the paper's SVE-version winners
    (Table III): DIA local, COO remote. ``impl`` maps to the kernel version
    ('plain' | 'cuda'); ``policy`` overrides it with a full
    ExecutionPolicy. ``local``/``remote`` hold one container per part.
    """

    mesh: PartMesh
    axis: str
    local: Tuple
    remote: Tuple
    halo: Optional[int]
    n: int
    local_fmt: str
    remote_fmt: str
    impl: str = "plain"
    policy: Optional[ExecutionPolicy] = None

    def execution_policy(self) -> ExecutionPolicy:
        return self.policy if self.policy is not None else policy_for_impl(self.impl)

    @classmethod
    def build(cls, s: sp.spmatrix, mesh: PartMesh, axis: str = "data",
              local_fmt: str = "dia", remote_fmt: str = "coo",
              impl: str = "plain", dtype=torch.float32, mode: str = "auto",
              policy: Optional[ExecutionPolicy] = None):
        nparts = mesh_parts(mesh, axis)
        locals_, remotes, halo = split_local_remote(
            s, nparts, halo=None if mode == "allgather" else "auto")
        lc = build_stacked(locals_, local_fmt, dtype, mesh.devices)
        rc = build_stacked(remotes, remote_fmt, dtype, mesh.devices)
        return cls(mesh, axis, lc, rc, halo, s.shape[0], local_fmt, remote_fmt,
                   impl, policy)

    @property
    def nparts(self) -> int:
        return mesh_parts(self.mesh, self.axis)

    def sharding(self) -> Tuple[PartRows, ...]:
        return tuple(PartRows(d, r0, r1) for d, (r0, r1) in
                     zip(self.mesh.devices, partition_rows(self.n, self.nparts)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        pol = self.execution_policy()
        m = x.shape[0] // self.nparts
        return run_parts(self.mesh, lambda p, dev: (
            spmv(self.local[p], x[p * m:(p + 1) * m].to(dev), policy=pol)
            + spmv(self.remote[p], halo_window(x, p, self.nparts, self.halo, dev),
                   policy=pol)))


def autotune_distributed(s: sp.spmatrix, mesh: PartMesh, axis: str = "data",
                         candidates=(("dia", "coo"), ("csr", "csr"),
                                     ("csr", "coo"), ("ell", "coo")),
                         impl: str = "plain", iters: int = 5):
    """Run-first tuner over (local_fmt, remote_fmt) pairs (Table III).
    Returns ``(best operator, {(local_fmt, remote_fmt): us or reason})``."""
    n = s.shape[0]
    home = mesh.home
    x = to_tensor(np.random.default_rng(0).standard_normal(n).astype(np.float32),
                  torch.float32, home)

    def sync():
        if home.type == "cuda":
            torch.cuda.synchronize(home)

    best, best_t, table = None, float("inf"), {}
    for lf, rf in candidates:
        try:
            op = DistributedSpMV.build(s, mesh, axis, lf, rf, impl)
        except Exception as e:
            table[(lf, rf)] = f"build failed: {type(e).__name__}"
            continue
        op(x)
        sync()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter_ns()
            op(x)
            sync()
            ts.append(time.perf_counter_ns() - t0)
        t = float(np.median(ts)) / 1e3
        table[(lf, rf)] = t
        if t < best_t:
            best, best_t = op, t
    return best, table
