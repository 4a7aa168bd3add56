"""Sparse matrix storage formats as frozen dataclasses of torch tensors.

The PyTorch counterpart of ``repro.core.formats``: the same containers
(COO / CSR / DIA / ELL / SELL / BSR / Dense) with the same fields, so a
matrix converted by either package holds equal arrays. There is no pytree
registration — PyTorch runs eagerly — and every container moves between
devices with ``.to(device)``.

All formats carry ``shape`` and expose:
  - ``format``      : str tag used by the dispatch table
  - ``nnz``         : stored entries (padded entries included where relevant)
  - ``to_dense()``  : densify (reference semantics for every test oracle)

Container-level indices are int32; a :class:`KernelPlan`'s tile-local
column indices may be int16/int8 (``core.tiling.local_index_dtype``).
Values are f32 by default; bf16/f16 storage accumulates in f32 inside every
``cuda`` kernel.

Also here: the dtype and device helpers every module of the package shares
(:func:`torch_dtype`, :func:`to_tensor`, :func:`resolve_device`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, Tuple

import numpy as np
import torch

Shape = Tuple[int, int]

_REGISTERED_FORMATS: dict = {}

# ------------------------------------------------------ dtypes and devices ----

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a name, or a numpy-like dtype
    (including an ml_dtypes bfloat16, read by name only)."""
    if isinstance(d, torch.dtype):
        return d
    name = d if isinstance(d, str) else np.dtype(d).name
    return _TORCH_DTYPES[name]


def dtype_name(d) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(torch_dtype(d)).replace("torch.", "")


def to_tensor(a, dtype, device) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``device``.

    The conversion rounds as the reference package's does: f16/f32 values
    are rounded by numpy; bf16 values go through f32 and torch's
    round-to-nearest-even (ml_dtypes rounds bf16 the same way). An array
    that already holds bf16 (an ml_dtypes array read from a reference
    container) keeps its bit pattern exactly.
    """
    t = torch_dtype(dtype)
    arr = np.asarray(a)
    if t is torch.bfloat16:
        if arr.dtype.name == "bfloat16":
            bits = np.ascontiguousarray(arr).view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
        f32 = np.ascontiguousarray(arr, np.float32)
        return torch.from_numpy(f32.copy()).to(torch.bfloat16).to(device)
    np_dt = np.dtype(dtype_name(t))
    return torch.from_numpy(np.array(arr, np_dt, copy=True, order="C")).to(device)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a card
    raises instead of running on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the host")
    return dev


def _move(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, KernelPlan):
        return v.to(device)
    return v


# ------------------------------------------------------------------ plan ----


@dataclass(frozen=True)
class KernelPlan:
    """A precomputed kernel layout attached to a container.

    Built on the host at convert time (``core.tiling``). ``arrays`` are the
    plan's tensors, ``kind`` and the ``meta`` geometry tuple are plain
    Python values the ``supports(A, policy)`` predicates test. Kinds:
    ``"ell-cols"``, ``"dia-cols"``, ``"coo-cols"``, ``"scs"``.
    ``meta[0]`` is always the column-tile width ``ct``.

    ``cache`` holds what a kernel derives from the plan once (the SCS
    window run boundaries, the DIA plan's checked arrays and offset range,
    the ELL plan's tile index); it is not part of the plan's value.
    """

    kind: str
    arrays: Tuple[Any, ...]
    meta: Tuple[int, ...]
    cache: Dict[str, Any] = field(default_factory=dict, compare=False,
                                  repr=False)

    @property
    def ct(self) -> int:
        return int(self.meta[0])

    @property
    def ntiles(self) -> int:
        return int(self.meta[1])

    def to(self, device) -> "KernelPlan":
        return KernelPlan(self.kind, tuple(a.to(device) for a in self.arrays),
                          self.meta)

    def index_dtype(self):
        """Dtype of the plan's tile-local column-index array, or None for
        kinds without per-entry indices ("dia-cols")."""
        pos = {"ell-cols": 0, "coo-cols": 1, "scs": 3}.get(self.kind)
        return None if pos is None else self.arrays[pos].dtype


# ------------------------------------------------------------ containers ----


def _register(cls):
    _REGISTERED_FORMATS[cls.format] = cls
    return cls


def format_class(name: str):
    return _REGISTERED_FORMATS[name]


def registered_formats():
    return tuple(sorted(_REGISTERED_FORMATS))


class _Container:
    """Shared behaviour: device moves and introspection."""

    format: ClassVar[str] = ""

    def tensors(self):
        """Every tensor of the container, its plan's included."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, KernelPlan):
                out.extend(v.arrays)
        return out

    def to(self, device):
        kw = {f.name: _move(getattr(self, f.name), device)
              for f in dataclasses.fields(self) if f.init}
        return type(self)(**kw)

    @property
    def device(self) -> torch.device:
        return self.tensors()[0].device


@_register
@dataclass(frozen=True)
class COO(_Container):
    """Coordinate format, row-sorted; tail pad sentinels are
    (row=nrows, col=0, val=0).

    ``cache`` holds what the full-window kernel derives from the container
    once (its checked arrays and row segment starts), as
    ``KernelPlan.cache`` does for a plan;
    it is not part of the value, and ``to`` starts a new one.
    """

    row: torch.Tensor  # (nnz,) int32, sorted non-decreasing
    col: torch.Tensor  # (nnz,) int32
    val: torch.Tensor  # (nnz,) float
    shape: Shape
    plan: Any = None   # optional KernelPlan ("coo-cols")
    cache: Dict[str, Any] = field(default_factory=dict, init=False, compare=False,
                                  repr=False)

    format: ClassVar[str] = "coo"

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def dtype(self):
        return self.val.dtype

    def to_dense(self) -> torch.Tensor:
        nrows, ncols = self.shape
        dense = torch.zeros((nrows + 1, ncols), dtype=self.val.dtype,
                            device=self.val.device)
        dense.index_put_((self.row.long(), self.col.long()), self.val,
                         accumulate=True)
        return dense[:nrows]


@_register
@dataclass(frozen=True)
class CSR(_Container):
    """Compressed Sparse Row. Entries past ``indptr[-1]`` are padding."""

    indptr: torch.Tensor   # (nrows+1,) int32
    indices: torch.Tensor  # (nnz,) int32
    data: torch.Tensor     # (nnz,) float
    shape: Shape
    plan: Any = None       # optional KernelPlan ("scs")

    format: ClassVar[str] = "csr"

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def row_ids(self) -> torch.Tensor:
        """Row of every stored entry (padding entries -> nrows)."""
        e = torch.arange(self.data.shape[0], dtype=self.indptr.dtype,
                         device=self.indptr.device)
        return torch.searchsorted(self.indptr, e, right=True) - 1

    def to_dense(self) -> torch.Tensor:
        nrows, ncols = self.shape
        dense = torch.zeros((nrows + 1, ncols), dtype=self.data.dtype,
                            device=self.data.device)
        dense.index_put_((self.row_ids().long(), self.indices.long()),
                         self.data, accumulate=True)
        return dense[:nrows]


@_register
@dataclass(frozen=True)
class DIA(_Container):
    """Diagonal format: ``data[d, i]`` holds A[i, i + offsets[d]].

    ``cache`` holds what the resident kernel's adapter checked on its first
    call (as ``COO.cache``); it is not part of the value.
    """

    offsets: torch.Tensor  # (ndiags,) int32, sorted
    data: torch.Tensor     # (ndiags, nrows) float, 0 where out of range
    shape: Shape
    plan: Any = None       # optional KernelPlan ("dia-cols")
    #: upper bound on max|offset| recorded by ``to_dia``; None = unknown
    extent: Any = None
    cache: Dict[str, Any] = field(default_factory=dict, init=False, compare=False,
                                  repr=False)

    format: ClassVar[str] = "dia"

    @property
    def ndiags(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    @property
    def dtype(self):
        return self.data.dtype

    def to_dense(self) -> torch.Tensor:
        nrows, ncols = self.shape
        dev = self.data.device
        i = torch.arange(nrows, device=dev)
        dense = torch.zeros((nrows, ncols), dtype=self.data.dtype, device=dev)
        for d in range(self.ndiags):
            k = i + self.offsets[d].long()
            valid = (k >= 0) & (k < ncols)
            contrib = torch.where(valid, self.data[d],
                                  torch.zeros((), dtype=self.data.dtype,
                                              device=dev))
            dense.index_put_((i, k.clamp(0, ncols - 1)), contrib,
                             accumulate=True)
        return dense


@_register
@dataclass(frozen=True)
class ELL(_Container):
    """ELLPACK: every row padded to ``width`` entries (col=-1 sentinel).

    ``cache`` holds the resident kernel's tile index of ``indices`` (as
    ``COO.cache``); it is not part of the value.
    """

    indices: torch.Tensor  # (nrows, width) int32, -1 = padding
    data: torch.Tensor     # (nrows, width) float, 0 at padding
    shape: Shape
    plan: Any = None       # optional KernelPlan ("ell-cols")
    cache: Dict[str, Any] = field(default_factory=dict, init=False, compare=False,
                                  repr=False)

    format: ClassVar[str] = "ell"

    @property
    def width(self) -> int:
        return int(self.indices.shape[1])

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    @property
    def dtype(self):
        return self.data.dtype

    def to_dense(self) -> torch.Tensor:
        nrows, ncols = self.shape
        dev = self.data.device
        rows = torch.arange(nrows, device=dev)[:, None].expand(self.indices.shape)
        valid = self.indices >= 0
        cols = torch.where(valid, self.indices, 0).long()
        vals = torch.where(valid, self.data,
                           torch.zeros((), dtype=self.data.dtype, device=dev))
        dense = torch.zeros((nrows, ncols), dtype=self.data.dtype, device=dev)
        dense.index_put_((rows.reshape(-1), cols.reshape(-1)),
                         vals.reshape(-1), accumulate=True)
        return dense


@_register
@dataclass(frozen=True)
class SELL(_Container):
    """SELL-C-sigma: entry (slice s, lane r, j) lives at
    ``sptr[s]*C + j*C + r``; ``perm`` maps slice rows to original rows
    (padding rows = nrows)."""

    sptr: torch.Tensor     # (nslices+1,) int32
    indices: torch.Tensor  # (total,) int32 flattened, -1 = padding
    data: torch.Tensor     # (total,) float flattened
    perm: torch.Tensor     # (nrows_padded,) int32
    shape: Shape
    C: int = 8
    plan: Any = None       # optional KernelPlan ("scs")

    format: ClassVar[str] = "sell"

    @property
    def nslices(self) -> int:
        return int(self.sptr.shape[0]) - 1

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def entry_rows(self) -> torch.Tensor:
        """Original row id of every flattened entry (padding rows -> nrows)."""
        total = self.data.shape[0]
        dev = self.data.device
        e = torch.arange(total, dtype=torch.int64, device=dev)
        base = self.sptr.long() * self.C
        s = torch.searchsorted(base, e, right=True) - 1
        lane = (e - base[s]) % self.C
        return self.perm.long()[s * self.C + lane]

    def to_dense(self) -> torch.Tensor:
        nrows, ncols = self.shape
        dev = self.data.device
        rows = self.entry_rows()
        valid = self.indices >= 0
        cols = torch.where(valid, self.indices, 0).long()
        vals = torch.where(valid, self.data,
                           torch.zeros((), dtype=self.data.dtype, device=dev))
        dense = torch.zeros((nrows + 1, ncols), dtype=self.data.dtype, device=dev)
        dense.index_put_((rows.clamp(max=nrows), cols), vals, accumulate=True)
        return dense[:nrows]


@_register
@dataclass(frozen=True)
class BSR(_Container):
    """Block CSR with square ``bs x bs`` blocks, block rows padded with
    bcol=-1 zero blocks to ``bwidth`` blocks (ELL-of-blocks)."""

    bcols: torch.Tensor   # (nbrows, bwidth) int32, -1 = padding
    blocks: torch.Tensor  # (nbrows, bwidth, bs, bs) float
    shape: Shape

    format: ClassVar[str] = "bsr"

    @property
    def bs(self) -> int:
        return int(self.blocks.shape[-1])

    @property
    def bwidth(self) -> int:
        return int(self.bcols.shape[1])

    @property
    def nnz(self) -> int:
        return int(np.prod(self.blocks.shape))

    @property
    def dtype(self):
        return self.blocks.dtype

    def to_dense(self) -> torch.Tensor:
        nrows, ncols = self.shape
        nbrows, bwidth = self.bcols.shape
        bs = self.bs
        dev = self.blocks.device
        nbcols = -(-ncols // bs)
        valid = self.bcols >= 0
        # park padding blocks in one extra block column, then cut it off
        bc = torch.where(valid, self.bcols, nbcols).long()
        blk = torch.where(valid[..., None, None], self.blocks,
                          torch.zeros((), dtype=self.blocks.dtype, device=dev))
        ar = torch.arange(bs, device=dev)
        rows = (torch.arange(nbrows, device=dev)[:, None, None, None] * bs
                + ar[None, None, :, None]).expand(blk.shape)
        cols = (bc[:, :, None, None] * bs + ar[None, None, None, :]).expand(blk.shape)
        dense = torch.zeros((nbrows * bs, (nbcols + 1) * bs),
                            dtype=self.blocks.dtype, device=dev)
        dense.index_put_((rows.reshape(-1), cols.reshape(-1)), blk.reshape(-1),
                         accumulate=True)
        return dense[:nrows, :ncols]


@dataclass(frozen=True)
class Dense(_Container):
    """Trivial 'format': the dense-matmul path."""

    data: torch.Tensor
    shape: Shape

    format: ClassVar[str] = "dense"

    @property
    def nnz(self) -> int:
        return int(np.prod(self.data.shape))

    @property
    def dtype(self):
        return self.data.dtype

    def to_dense(self) -> torch.Tensor:
        return self.data


_REGISTERED_FORMATS["dense"] = Dense

AnySparse = Any  # union of the containers above
