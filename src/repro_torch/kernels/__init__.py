"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

    sell_spmv : scs_spmv (csr and sell), replaces sell_spmv.py:64
    dia_spmv  : dia_spmv and dia_spmv_tiled, replace dia_spmv.py:58 and :135
    ell_spmv  : ell_spmv and ell_spmv_tiled, replace ell_spmv.py:43 and :92
    coo_spmv  : coo_spmv, scoo_spmv (with its host layout build_scoo) and
                scoo_spmv_tiled, replace coo_spmv.py:85, :141 and :200
    bsr_spmm  : bsr_spmm (bsr SpMM, SpMV and masked SpMV), replaces
                bsr_spmm.py:44
    ops       : the ``cuda`` backend registrations and capability predicates
    ref       : torch oracles (densify + matmul)
    _build    : compiles ``csrc/*.cu`` with nvcc at first launch
    _launch   : the wrappers' operand checks, and ``graph_nodes`` (a
                captured CUDA graph's node count)
"""
from ._launch import graph_nodes
from .bsr_spmm import bsr_spmm, bsr_spmm_plain
from .coo_spmv import build_scoo, scoo_spmv, scoo_spmv_plain

__all__ = ["build_scoo", "bsr_spmm", "bsr_spmm_plain", "graph_nodes", "launch_counts",
           "scoo_spmv", "scoo_spmv_plain", "wrappers"]


def wrappers() -> dict:
    """Every kernel wrapper by name; each counts its launches in ``launches``."""
    from .bsr_spmm import bsr_sddmm, bsr_spmm, bsr_spmm_t
    from .coo_spmv import coo_spmv, scoo_spmv, scoo_spmv_tiled
    from .dia_spmv import dia_spmv, dia_spmv_tiled
    from .ell_spmv import ell_spmv, ell_spmv_tiled
    from .sell_spmv import scs_spmv

    return {"scs_spmv": scs_spmv, "dia_spmv": dia_spmv, "dia_spmv_tiled": dia_spmv_tiled,
            "ell_spmv": ell_spmv, "ell_spmv_tiled": ell_spmv_tiled, "coo_spmv": coo_spmv,
            "scoo_spmv_tiled": scoo_spmv_tiled, "scoo_spmv": scoo_spmv, "bsr_spmm": bsr_spmm,
            "bsr_spmm_t": bsr_spmm_t, "bsr_sddmm": bsr_sddmm}


def launch_counts() -> dict:
    """Each kernel wrapper's launches in this process, by name."""
    return {name: fn.launches for name, fn in wrappers().items()}
