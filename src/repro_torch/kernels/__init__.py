"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

    sell_spmv : scs_spmv (csr and sell), replaces sell_spmv.py:64
    dia_spmv  : dia_spmv and dia_spmv_tiled, replace dia_spmv.py:58 and :135
    ops       : the ``cuda`` backend registrations and capability predicates
    ref       : torch oracles (densify + matmul)
    _build    : compiles ``csrc/*.cu`` with nvcc at first launch
"""
