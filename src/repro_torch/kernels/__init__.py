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
"""
from .bsr_spmm import bsr_spmm, bsr_spmm_plain
from .coo_spmv import build_scoo, scoo_spmv, scoo_spmv_plain

__all__ = ["build_scoo", "bsr_spmm", "bsr_spmm_plain", "scoo_spmv", "scoo_spmv_plain"]
