"""``DistributedOperator`` — a row-partitioned sparse operator over a mesh of parts.

The PyTorch counterpart of ``repro.distributed_op.operator``. It partitions
a sparse matrix row-wise over a 1-D :class:`~repro_torch.core.distributed.PartMesh`
and runs SpMV the way the Morpheus-enabled HPCG does (paper §VII-D) — each
part's rows are *physically split* into a structured **local** block (the
columns the part owns) and an unstructured **remote** block (halo columns),
and for each part the SpMV is

    1. the halo exchange of the remote x entries    (neighbour slices / all of x)
    2. local-part SpMV against the part's own x shard
    3. remote-part SpMV against the exchanged window

The reference runs this per-shard program under ``shard_map``, one program
on every device; here one process loops over the parts, and the part
outputs are concatenated on the mesh's home device. Vectors are global
tensors on the home device: ``device_put`` places a host vector there, and
``@`` refuses a tensor on any other device.

Per-part format choices (Table III: the run-first tuner lands on different
formats per process) are kept as **format groups**: parts that picked the
same ``DispatchKey(format, backend)`` share one group, which holds one
container per part — its members' matrices, and for the other parts an
empty (all-padding) matrix, as the reference's stacked container holds, so
the groups' arrays and ``nbytes`` equal the reference's. Only members run
their group's kernel: a non-member's part contributes exact zeros in the
reference, and here nothing. Every per-part kernel goes through the same
``DispatchKey`` dispatch (``core/spmv.py``) as single-device SpMV, under
:meth:`FormatGroup.policy`; on the card a ``cuda`` kernel that dispatch
selects runs or raises.

Modes:
  - ``"auto"``      : halo (neighbour) exchange when a finite halo covers all
                      remote entries, else allgather.
  - ``"halo"``      : require the finite-halo neighbour exchange.
  - ``"allgather"`` : force global-coordinate remotes + the whole x per part.
  - ``"rowblock"``  : no column split — each part keeps its full ``(mr, nc)``
                      row block and multiplies against the whole x. Every
                      row accumulates in exactly the global CSR entry order,
                      so csr/plain results are **bit-for-bit** identical to
                      the single-device kernel: the validation mode of the
                      distributed HPCG pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core import health as _health
from repro_torch.core.convert import _as_scipy
from repro_torch.core.distributed import (
    PartMesh,
    PartRows,
    build_stacked,
    halo_window,
    mesh_parts,
    partition_rows,
    run_parts,
    split_local_remote,
    split_rowblocks,
)
from repro_torch.core.formats import to_tensor, torch_dtype
from repro_torch.core.operator import DEFAULT_POLICY, ExecutionPolicy, SparseOperator
from repro_torch.core.spmv import DispatchKey, masked_spmv, select_spmv, spmv

#: Formats whose per-part containers have the reference's common padded
#: shape (its shard_map layout stacks them). SELL's per-slice ragged layout
#: and BSR's block grid have no such padding rule.
STACKABLE_FORMATS = ("coo", "csr", "dia", "ell")

KeyLike = Union[str, Tuple[str, str], DispatchKey]


def as_dispatch_key(k: KeyLike) -> DispatchKey:
    """Normalise a format name / ``(fmt, backend)`` pair / ``DispatchKey``.

    >>> as_dispatch_key("dia")
    DispatchKey(format='dia', backend='plain')
    >>> as_dispatch_key(("ell", "cuda"))
    DispatchKey(format='ell', backend='cuda')
    """
    if isinstance(k, DispatchKey):
        return k
    if isinstance(k, str):
        return DispatchKey(k, "plain")
    fmt, backend = k
    return DispatchKey(fmt, backend)


def _maybe_drop_halo(xr):
    """Fault-injection site "halo": an armed plan may zero the exchanged
    window (a dropped neighbour message) so tests can prove the distributed
    result goes detectably wrong rather than silently so. One ``None`` check
    when no plan is armed."""
    plan = _health.fault_plan()
    if plan is None:
        return xr
    return plan.drop("halo", None, xr)


def _per_part_keys(spec, nparts: int) -> Tuple[DispatchKey, ...]:
    """Broadcast a single choice, or validate a per-part sequence.

    A bare ``"csr"``, a ``DispatchKey``, or a 2-tuple of strings (read as a
    ``(format, backend)`` pair) applies to every part; any other sequence is
    one choice per part and must have length ``nparts``.
    """
    if isinstance(spec, (str, DispatchKey)) or (
            isinstance(spec, tuple) and len(spec) == 2
            and all(isinstance(e, str) for e in spec)):
        return (as_dispatch_key(spec),) * nparts
    keys = tuple(as_dispatch_key(k) for k in spec)
    if len(keys) != nparts:
        raise ValueError(f"need one format choice per part: got {len(keys)} "
                         f"for {nparts} parts")
    return keys


@dataclass(frozen=True)
class FormatGroup:
    """Parts sharing one (format, backend) choice + one container per part.

    ``container[p]`` lies on part ``p``'s device; parts outside ``members``
    hold an empty (all-padding) matrix and run nothing.
    """

    key: DispatchKey
    container: Tuple[Any, ...]
    members: Tuple[int, ...]

    def policy(self, base: Optional[ExecutionPolicy]) -> ExecutionPolicy:
        return (base if base is not None else DEFAULT_POLICY).preferring(
            self.key.backend)


def _build_groups(mats: Sequence[sp.spmatrix], keys: Sequence[DispatchKey],
                  dtype, devices) -> Tuple[FormatGroup, ...]:
    """Group per-part matrices by dispatch key and build each group's parts.

    Groups whose member matrices are all empty are dropped entirely (their
    rows contribute exact zeros) — e.g. the remote groups of a matrix with
    no off-partition entries, which then skips the halo exchange too.
    """
    for key in keys:
        if key.format not in STACKABLE_FORMATS:
            raise ValueError(
                f"distributed containers must be one of {STACKABLE_FORMATS}, "
                f"got {key.format!r} (sell/bsr do not stack across parts)")
    groups: List[FormatGroup] = []
    seen: List[DispatchKey] = []
    for key in keys:
        if key in seen:
            continue
        seen.append(key)
        members = tuple(p for p, k in enumerate(keys)
                        if k == key and mats[p].nnz > 0)
        if not members:
            continue
        sel = [mats[p] if keys[p] == key else sp.csr_matrix(mats[p].shape)
               for p in range(len(mats))]
        groups.append(FormatGroup(key, build_stacked(sel, key.format, dtype, devices),
                                  members))
    return tuple(groups)


def _tag(key: DispatchKey, ran: Optional[DispatchKey]) -> str:
    tag = f"{key.format}/{key.backend}"
    return tag if ran is None or ran == key else f"{tag}->{ran.format}/{ran.backend}"


@dataclass(frozen=True)
class DistributedOperator:
    """Row-partitioned sparse linear operator: ``A @ x`` over a part mesh.

    Built with :meth:`build` (or the :func:`distribute` convenience).

    Attributes:
        mesh / axis: the 1-D mesh of parts rows are partitioned over.
        shape: global ``(nr, nc)``.
        dtype: value dtype of the containers (and of the vectors).
        halo: window half-width of the neighbour exchange, or ``None`` when
            each part reads the whole x.
        mode: ``"split"`` (local/remote) or ``"rowblock"`` (exact, see
            module docstring).
        local_groups / remote_groups: :class:`FormatGroup`s; remote is
            empty in rowblock mode or when no entries leave the partition.
        choices: per-part ``(local_key, remote_key)`` dispatch choices.
        base_policy: optional ``ExecutionPolicy`` whose limits every group's
            kernel runs under (the backend preference comes from the group).
    """

    mesh: PartMesh
    axis: str
    shape: Tuple[int, int]
    dtype: Any
    halo: Optional[int]
    mode: str
    local_groups: Tuple[FormatGroup, ...]
    remote_groups: Tuple[FormatGroup, ...]
    choices: Tuple[Tuple[DispatchKey, Optional[DispatchKey]], ...]
    base_policy: Optional[ExecutionPolicy] = None
    source: Any = field(default=None, repr=False, compare=False)

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, a, mesh: PartMesh, axis: str = "data",
              local: KeyLike = "csr", remote: KeyLike = "coo",
              mode: str = "auto", policy: Optional[ExecutionPolicy] = None,
              dtype=torch.float32) -> "DistributedOperator":
        """Partition ``a`` row-wise over ``mesh[axis]`` with a local/remote split.

        Args:
            a: anything ``as_operator`` accepts — scipy sparse, dense,
                a registered container, or a ``SparseOperator``.
            mesh / axis: the 1-D mesh of parts. Both matrix dims must be
                divisible by ``mesh.shape[axis]``.
            local / remote: per-part kernel choice for the local and remote
                blocks — a format name (backend ``plain``), a
                ``(format, backend)`` pair / ``DispatchKey``, or a sequence
                of one choice per part (Table III heterogeneous tuning).
            mode: ``"auto" | "halo" | "allgather" | "rowblock"`` (see module
                docstring). ``remote`` is ignored in rowblock mode.
            policy: optional base ``ExecutionPolicy``; each group's backend
                preference is layered on top of it.
            dtype: value dtype of the containers.
        """
        s = _as_scipy(a).tocsr()
        nparts = mesh_parts(mesh, axis)
        dtype = torch_dtype(dtype)
        nr, nc = s.shape
        if nr % nparts or nc % nparts:
            raise ValueError(f"matrix dims {s.shape} must be divisible by "
                             f"the mesh axis {axis!r} of size {nparts} "
                             f"(pad upstream)")
        devs = mesh.devices
        if mode == "rowblock":
            blocks = split_rowblocks(s, nparts)
            lkeys = _per_part_keys(local, nparts)
            groups = _build_groups(blocks, lkeys, dtype, devs)
            return cls(mesh, axis, (nr, nc), dtype, None, "rowblock", groups, (),
                       tuple((k, None) for k in lkeys), policy, s)
        if mode not in ("auto", "halo", "allgather"):
            raise ValueError(f"unknown mode {mode!r}")
        locals_, remotes, halo = split_local_remote(
            s, nparts, halo=None if mode == "allgather" else "auto")
        if mode == "halo" and halo is None:
            raise ValueError("mode='halo': no finite halo covers the remote "
                             "entries; use 'allgather' (or 'auto')")
        lkeys = _per_part_keys(local, nparts)
        rkeys = _per_part_keys(remote, nparts)
        return cls(mesh, axis, (nr, nc), dtype, halo, "split",
                   _build_groups(locals_, lkeys, dtype, devs),
                   _build_groups(remotes, rkeys, dtype, devs),
                   tuple(zip(lkeys, rkeys)), policy, s)

    # -- introspection ------------------------------------------------------

    @property
    def nparts(self) -> int:
        return mesh_parts(self.mesh, self.axis)

    @property
    def format(self) -> str:
        """Summary tag, e.g. ``'dist(dia+coo)'`` — per-part detail is in
        :meth:`describe`."""
        lf = "|".join(sorted({g.key.format for g in self.local_groups}) or ["-"])
        if self.mode == "rowblock":
            return f"dist[{lf}]"
        rf = "|".join(sorted({g.key.format for g in self.remote_groups}) or ["-"])
        return f"dist({lf}+{rf})"

    @property
    def policy(self) -> Optional[ExecutionPolicy]:
        return self.base_policy

    @property
    def nbytes(self) -> int:
        """Bytes of every group's containers, non-members' padding included
        (the reference's stacked bytes)."""
        return sum(SparseOperator(c).nbytes for g in self.local_groups + self.remote_groups
                   for c in g.container)

    def dispatched(self) -> Tuple[Tuple[Optional[DispatchKey], Optional[DispatchKey]], ...]:
        """Per part, the ``(local, remote)`` keys dispatch runs: ``select_spmv``
        on the part's container under its group's policy, ``None`` where the
        block is empty and runs nothing. A part carries no plan, so a chosen
        key whose kernel needs one (csr/cuda; coo/cuda above
        ``max_onehot_rows``) runs the next backend of its chain, plain."""
        def runs(groups, p):
            for g in groups:
                if p in g.members:
                    return select_spmv(g.container[p], g.policy(self.base_policy)).key
            return None

        return tuple((runs(self.local_groups, p), runs(self.remote_groups, p))
                     for p in range(self.nparts))

    def describe(self, dispatched: bool = False) -> str:
        """Per-part choices, e.g. ``'p0:dia/plain+coo/plain p1:csr/plain+coo/plain'``.
        With ``dispatched=True`` a choice that dispatch does not run is
        followed by the key it runs, e.g. ``'csr/cuda->csr/plain'``."""
        runs = self.dispatched() if dispatched else ((None, None),) * self.nparts
        out = []
        for p, ((lk, rk), (lr, rr)) in enumerate(zip(self.choices, runs)):
            tag = _tag(lk, lr)
            if rk is not None:
                tag += "+" + _tag(rk, rr)
            out.append(f"p{p}:{tag}")
        return " ".join(out)

    def __repr__(self):
        return (f"DistributedOperator(shape={self.shape}, mode={self.mode!r}, "
                f"nparts={self.nparts}, halo={self.halo}, "
                f"format={self.format!r})")

    # -- placement ----------------------------------------------------------

    def sharding(self) -> Tuple[PartRows, ...]:
        """Where each part's rows of the output (and of x: the same ranges
        for a square operator) are computed: ``(device, r0, r1)`` a part."""
        return tuple(PartRows(d, r0, r1) for d, (r0, r1) in
                     zip(self.mesh.devices, partition_rows(self.shape[0], self.nparts)))

    def device_put(self, x) -> torch.Tensor:
        """A host vector as a tensor in this operator's dtype on the mesh's
        home device, where the operator takes and returns vectors."""
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=self.mesh.home, dtype=self.dtype)
        return to_tensor(np.asarray(x), self.dtype, self.mesh.home)

    def _operand(self, v, what: str) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            return torch.as_tensor(np.asarray(v), device=self.mesh.home)
        if v.device != self.mesh.home:
            raise ValueError(f"DistributedOperator: {what} lies on {v.device}; the "
                             f"operator takes vectors on its home device "
                             f"{self.mesh.home} (use device_put)")
        return v

    # -- application --------------------------------------------------------

    def __matmul__(self, x):
        x = self._operand(x, "x")
        if x.ndim != 1:
            raise ValueError(
                f"DistributedOperator @ ndim={x.ndim}: only SpMV (1-D x) is "
                f"distributed; loop over columns for SpMM")
        if x.shape[0] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ {tuple(x.shape)}")
        return self._apply(x, None)

    def matvec(self, x) -> torch.Tensor:
        """``A @ x`` — a global vector in, a global vector out."""
        return self @ x

    def masked_matvec(self, x, row_mask) -> torch.Tensor:
        """``where(row_mask, A @ x, 0)`` — one color of a distributed
        multicolor SymGS sweep. ``row_mask`` is a global ``(nr,)`` bool
        tensor on the home device."""
        x = self._operand(x, "x")
        mask = self._operand(row_mask, "row_mask")
        if mask.dtype is not torch.bool or mask.shape != (self.shape[0],):
            raise ValueError(f"row_mask must be bool of shape ({self.shape[0]},)")
        return self._apply(x, mask)

    def _apply(self, x, mask):
        mr, mc = self.shape[0] // self.nparts, self.shape[1] // self.nparts
        return run_parts(self.mesh, lambda p, dev: self._part(
            p, dev, x, None if mask is None else mask[p * mr:(p + 1) * mr].to(dev), mr, mc))

    def _part(self, p: int, dev, x, mask, mr: int, mc: int) -> torch.Tensor:
        """Part ``p``'s program: the exchange first, then its local and its
        remote groups' SpMV summed from zeros in group order."""
        xr = None
        if self.mode == "rowblock":
            xr = x.to(dev)
        elif self.remote_groups:
            xr = halo_window(x, p, self.nparts, self.halo, dev)
        if xr is not None:
            xr = _maybe_drop_halo(xr)
        xl = xr if self.mode == "rowblock" else x[p * mc:(p + 1) * mc].to(dev)
        y = torch.zeros((mr,), dtype=self.dtype, device=dev)
        for g in self.local_groups:
            if p in g.members:
                y = y + self._group_spmv(g, g.container[p], xl, mask)
        for g in self.remote_groups:
            if p in g.members:
                y = y + self._group_spmv(g, g.container[p], xr, mask)
        return y

    def _group_spmv(self, g: FormatGroup, A, x, mask):
        pol = g.policy(self.base_policy)
        if mask is None:
            return spmv(A, x, policy=pol)
        return masked_spmv(A, x, mask, policy=pol)

    # -- retargeting --------------------------------------------------------

    def with_policy(self, policy: Optional[ExecutionPolicy]) -> "DistributedOperator":
        """Same containers, different base ``ExecutionPolicy`` limits."""
        return replace(self, base_policy=policy)

    def tune(self, candidates=None, mode: Optional[str] = None,
             **kw) -> "DistributedOperator":
        """Per-partition run-first auto-tune (paper §VII-D, Table III).

        Each part's local and remote block is tuned *independently* over
        ``candidates`` (default: the plain stackable formats) and the
        operator is rebuilt with the per-part winners — parts that pick
        different formats land in different :class:`FormatGroup`s.

        Raises:
            ValueError: on a ``rowblock``-mode operator — rowblock exists
                for its bit-for-bit accumulation order, which any tuned
                local/remote split would discard; build a split-mode
                operator (``mode="auto"``) to tune instead.
        """
        from .tune import tune_partitions

        if self.mode == "rowblock":
            raise ValueError(
                "refusing to tune a rowblock (exact validation) operator: "
                "the tuned local/remote split changes the per-row "
                "accumulation order and loses the bit-for-bit guarantee; "
                "build with mode='auto' (or call tune_partitions) instead")
        if self.source is None:
            raise ValueError("operator was built without a host-side source "
                             "matrix; re-tune via tune_partitions(s, mesh)")
        op, _ = tune_partitions(
            self.source, self.mesh, self.axis, candidates=candidates,
            mode=mode if mode is not None else
            ("allgather" if self.halo is None else "auto"),
            policy=self.base_policy, dtype=self.dtype, **kw)
        return op


def distribute(a, mesh: PartMesh, axis: str = "data", **kw) -> DistributedOperator:
    """Convenience alias for :meth:`DistributedOperator.build`."""
    return DistributedOperator.build(a, mesh, axis, **kw)
