"""repro_torch.distributed_op — row-partitioned sparse operators (halo-exchange SpMV).

The distribution layer over the core format/dispatch abstraction, the
PyTorch counterpart of ``repro.distributed_op``:

    DistributedOperator : a row-partitioned sparse operator over a
        ``PartMesh`` — per part, the halo exchange, the local-part SpMV and
        the remote-part SpMV; per-part (format, backend) choices via format
        groups, a ``rowblock`` exact mode for bit-for-bit validation, and
        ``masked_matvec`` so the multicolor SymGS smoother distributes
        unchanged.
    distribute          : convenience constructor.
    tune_partitions     : per-partition run-first auto-tuner (Table III).
"""
from .operator import (
    STACKABLE_FORMATS,
    DistributedOperator,
    FormatGroup,
    as_dispatch_key,
    distribute,
)
from .tune import DISTRIBUTED_CANDIDATES, tune_partitions

__all__ = [
    "STACKABLE_FORMATS",
    "DistributedOperator",
    "FormatGroup",
    "as_dispatch_key",
    "distribute",
    "DISTRIBUTED_CANDIDATES",
    "tune_partitions",
]
