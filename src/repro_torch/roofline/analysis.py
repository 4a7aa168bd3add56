"""Three-term roofline over counts taken from torch itself (NVIDIA H100
model): the port of ``repro.roofline.analysis``.

compute   = FLOPs_per_device / PEAK_FLOPS     (989 TFLOP/s bf16, dense)
memory    = bytes_per_device / HBM_BW         (3.35 TB/s)
collective= collective_bytes_per_device / LINK_BW   (450 GB/s NVLink, each way)

The reference reads its FLOPs and bytes from ``compiled.cost_analysis()``
and its collectives from the compiled HLO text. The port has no compiled
program: :class:`CountingMode` runs a function (on ``meta`` tensors, so
nothing is allocated) and counts what it dispatches. FLOPs come from
``torch.utils.flop_counter``'s registry; bytes accessed are the sum of every
aten op's input and output bytes, XLA's convention (view ops, which move
nothing, are left out); every ``_c10d_functional`` collective goes into a
:class:`CollectiveStats`. An eager trace runs every layer and every loop
trip, so its counts are whole: the reference divides by a trip count
because XLA counts a ``while`` body once; here a multiplier applies only to
what :meth:`CountingMode.body` marks as a loop body run once for many.

The HLO text parser of the reference (``parse_collectives``) is not ported:
the port has no HLO.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W
# power limit (a card set lower runs slower under load: state its limit
# beside any share of these).
PEAK_FLOPS = 989e12          # bf16 / card, tensor cores
HBM_BW = 3.35e12             # bytes/s / card, HBM3
#: NVLink 4 within one 8-card host: 900 GB/s a card in all, 450 each way.
#: A 16-wide model axis spans two 8-card hosts, whose link (InfiniBand or
#: the NVLink switch system) this repo has no number for: the collective
#: term takes the NVLink rate throughout.
LINK_BW = 450e9              # bytes/s / card, each way
#: f32 outside the tensor cores: the roofline of a CUDA-core f32 SpMV.
F32_FLOPS = 67e12
#: TF32 on the tensor cores (dense).
TF32_FLOPS = 495e12
#: f32 products on the tensor cores at f32 accuracy: a 3xTF32 split takes
#: three passes at the TF32 rate (one pass misses rtol 2e-4), the fastest
#: rate at which the card meets ``bsr_spmm``'s tolerance.
TF32X3_FLOPS = TF32_FLOPS / 3

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2, torch.uint16: 2,
    torch.float16: 2, torch.bfloat16: 2, torch.int32: 4, torch.uint32: 4,
    torch.float32: 4, torch.int64: 8, torch.uint64: 8, torch.float64: 8,
    torch.complex64: 8, torch.complex128: 16, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1,
}


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of an array of ``shape`` and ``dtype`` (0 for a dtype outside
    the table, as the reference's ``token``/``opaque``)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 0)


def tensor_bytes(t: torch.Tensor) -> int:
    return shape_bytes(t.shape, t.dtype)


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    entry_bytes: int = 0      # collectives outside a marked loop body (run once)
    body_bytes: int = 0       # collectives inside CountingMode.body()
    entry_wire: int = 0       # ring-wire estimates (see _wire_estimate)
    body_wire: int = 0

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def corrected_bytes(self, loop_multiplier: int) -> int:
        """A marked body stands for ``loop_multiplier`` runs of itself."""
        return self.entry_bytes + self.body_bytes * loop_multiplier

    def corrected_wire(self, loop_multiplier: int) -> int:
        return self.entry_wire + self.body_wire * loop_multiplier

    def add_scaled(self, coef: int, other: "CollectiveStats") -> None:
        """``self += coef * other``, kind by kind (whole numbers)."""
        for kind, b in other.bytes_by_kind.items():
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + coef * b
        for kind, n in other.count_by_kind.items():
            self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + coef * n
        self.entry_bytes += coef * other.entry_bytes
        self.body_bytes += coef * other.body_bytes
        self.entry_wire += coef * other.entry_wire
        self.body_wire += coef * other.body_wire

    def add(self, kind: str, operand_bytes: int, result_bytes: int, body: bool) -> None:
        wire = _wire_estimate(kind, operand_bytes, result_bytes)
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + operand_bytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        if body:
            self.body_bytes += operand_bytes
            self.body_wire += wire
        else:
            self.entry_bytes += operand_bytes
            self.entry_wire += wire


def _wire_estimate(kind: str, operand_bytes: int, result_bytes: int) -> int:
    """Ring-algorithm wire bytes per device: all-reduce moves ~2x its operand,
    all-gather moves ~its (full) result, reduce-scatter/all-to-all/permute
    move ~their operand."""
    if kind == "all-reduce":
        return 2 * operand_bytes
    if kind == "all-gather":
        return max(result_bytes, operand_bytes)
    return operand_bytes


#: ``torch.ops._c10d_functional`` op name -> the reference's HLO kind.
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class Counts:
    """What one traced run dispatched: the counterpart of XLA's
    ``cost_analysis()`` (``flops``, ``bytes accessed``) and of the
    collectives parsed from HLO. ``collectives`` is ``None`` where nothing
    of the run is placed over several devices, so no collective term
    exists (a 0 would claim one that is never the bound)."""

    flops: int = 0
    bytes_accessed: int = 0
    ops: int = 0
    collectives: Optional[CollectiveStats] = field(default_factory=CollectiveStats)


class CountingMode(TorchDispatchMode):
    """Counts the FLOPs, bytes and collectives of everything dispatched
    while it is active, into ``self.counts``.

    An op on DTensors is handed on to DTensor (the mode answers
    ``NotImplemented``), so the mode sees what DTensor runs for it: the
    local ops and every collective of a redistribute, implicit or not, on
    the local shards (per-device bytes). With ``collectives_only`` it
    counts those collectives and nothing else: DTensor's sharding
    propagation runs ops of its own (on global shapes, on a cache miss),
    which would pollute FLOPs and bytes.

    Example:
        >>> a, b = torch.empty(64, 32, device="meta"), torch.empty(32, 16, device="meta")
        >>> with CountingMode() as c:
        ...     _ = a @ b
        >>> c.counts.flops, c.counts.bytes_accessed
        (65536, 14336)
    """

    def __init__(self, collectives_only: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.counts = Counts()
        self._body = 0
        self._collectives_only = collectives_only

    @contextlib.contextmanager
    def body(self):
        """Collectives dispatched inside count as a loop body's, which
        ``CollectiveStats.corrected_bytes`` multiplies."""
        self._body += 1
        try:
            yield
        finally:
            self._body -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counts
        packet = func._overloadpacket
        if not self._collectives_only:
            c.ops += 1
            if packet in self._flops:
                c.flops += int(self._flops[packet](*args, **kwargs, out_val=out))
        if func.namespace == "_c10d_functional":
            name = packet.__name__
            if name == "wait_tensor":
                return out
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                operand = sum(tensor_bytes(t) for t in tree_leaves(args)
                              if isinstance(t, torch.Tensor))
                result = sum(tensor_bytes(t) for t in tree_leaves(out)
                             if isinstance(t, torch.Tensor))
                c.collectives.add(kind, operand, result, self._body > 0)
        if not func.is_view and not self._collectives_only:
            c.bytes_accessed += sum(tensor_bytes(t) for t in tree_leaves((args, kwargs, out))
                                    if isinstance(t, torch.Tensor))
        return out


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: Optional[float]
    collectives: Optional[Dict[str, int]]
    collective_counts: Optional[Dict[str, int]]
    raw_flops: float = 0.0           # the counts as traced
    raw_hbm_bytes: float = 0.0
    raw_collective_bytes: Optional[float] = 0.0
    loop_multiplier: int = 1
    wire_bytes: Optional[float] = 0.0  # ring-wire estimate (loop-corrected)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        """``None`` where no collective term exists."""
        if self.collective_bytes is None:
            return None
        return self.collective_bytes / LINK_BW

    def _terms(self) -> Dict[str, float]:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return {k: v for k, v in ts.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        ts = self._terms()
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self._terms().values())

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_bytes_by_kind": self.collectives,
            "collective_counts": self.collective_counts,
            "raw_cost_analysis": {"flops": self.raw_flops,
                                  "bytes_accessed": self.raw_hbm_bytes,
                                  "collective_bytes_uncorrected": self.raw_collective_bytes},
            "loop_multiplier": self.loop_multiplier,
            "wire_bytes_per_device": self.wire_bytes,
            "t_collective_wire_s": (None if self.wire_bytes is None
                                    else self.wire_bytes / LINK_BW),
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_bound_s": self.t_bound,
        }


def analyze(counts: Counts, loop_multiplier: int = 1, analytic=None) -> Roofline:
    """Roofline terms from ``counts`` (a :class:`Counts`). FLOPs/bytes come
    from ``analytic`` (AnalyticCost) when given, with the counts kept
    alongside; collective bytes come from the counted collectives, a marked
    body's multiplied by ``loop_multiplier``."""
    raw_flops = float(counts.flops)
    raw_hbm = float(counts.bytes_accessed)
    flops = analytic.flops_per_device if analytic else raw_flops
    hbm = analytic.hbm_bytes_per_device if analytic else raw_hbm
    stats = counts.collectives
    if stats is None:
        return Roofline(flops, hbm, None, None, None, raw_flops, raw_hbm, None,
                        loop_multiplier, None)
    return Roofline(flops, hbm, float(stats.corrected_bytes(loop_multiplier)),
                    stats.bytes_by_kind, stats.count_by_kind,
                    raw_flops, raw_hbm, float(stats.total_bytes), loop_multiplier,
                    float(stats.corrected_wire(loop_multiplier)))


def model_flops(cfg, shape, chips: int) -> float:
    """MODEL_FLOPS per device: 6*N*D train / 2*N*D_token decode-prefill
    (N = active params)."""
    from .analytic import param_counts

    n_active = param_counts(cfg)[0]
    toks = shape.tokens if shape.kind != "decode" else shape.global_batch
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * toks / chips
