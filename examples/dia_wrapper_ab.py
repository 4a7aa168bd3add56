"""Host time of the DIA wrappers (dia/cuda, masked too) in two trees of
the port, on the card.

  python examples/dia_wrapper_ab.py OLD_TREE NEW_TREE

Calls the dispatch entries ``ops.dia_spmv_cuda`` and
``ops.dia_masked_spmv_cuda`` (the mask of the first SymGS color, as
``SymGS.build`` makes it) on the dia containers of HPCG's 13^3 and 104^3
levels (the resident kernel) and on the 104^3 level under
``max_resident_cols=1<<18`` (``104^3 tiled``: the tiled kernel on the
``"dia-cols"`` plan), one process per tree, in alternating rounds;
``examples/_wrapper_ab.py`` says what each round reports. Needs a CUDA card
and nvcc.
"""
from _wrapper_ab import run


def calls(dev):
    import numpy as np
    import torch

    from repro_torch.core import ExecutionPolicy
    from repro_torch.core import matrices as M
    from repro_torch.core.convert import to_dia
    from repro_torch.kernels import ops
    from repro_torch.solvers.symgs import greedy_coloring

    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
    out = {}
    for g in (13, 104):
        s = M.fdm27(g, g, g)
        n = s.shape[0]
        D = to_dia(s, device=dev)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                             .astype(np.float32)).to(dev)
        mask = torch.from_numpy(greedy_coloring(s) == 0).to(dev)
        out[f"{g}^3"] = lambda D=D, x=x: ops.dia_spmv_cuda(D, x, pol)
        out[f"{g}^3 masked"] = lambda D=D, x=x, m=mask: ops.dia_masked_spmv_cuda(D, x, m, pol)
    tpol = ExecutionPolicy(backends=("cuda",), allow_fallback=False,
                           max_resident_cols=1 << 18)
    DT = to_dia(s, col_tile=tpol.col_tile(n), device=dev)
    assert ops.cuda_strategy(DT, tpol) == "tiled"
    out["104^3 tiled"] = lambda: ops.dia_spmv_cuda(DT, x, tpol)
    out["104^3 tiled masked"] = lambda: ops.dia_masked_spmv_cuda(DT, x, mask, tpol)
    return out


if __name__ == "__main__":
    run(__file__, calls, "dia_", __doc__)
