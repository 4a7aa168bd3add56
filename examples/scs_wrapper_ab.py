"""Host time of the SELL-C-σ wrapper (csr/cuda, sell/cuda) in two trees of
the port, on the card.

  python examples/scs_wrapper_ab.py OLD_TREE NEW_TREE

Calls the dispatch adapter ``scs_spmv_from_plan`` on the csr containers of
HPCG's 52^3 (resident plan) and 104^3 (tiled plan), one process per tree,
in alternating rounds; ``examples/_wrapper_ab.py`` says what each round
reports. Needs a CUDA card and nvcc.
"""
from _wrapper_ab import run


def calls(dev):
    import numpy as np
    import torch

    from repro_torch.core import matrices as M
    from repro_torch.core.convert import to_csr
    from repro_torch.kernels.sell_spmv import scs_spmv_from_plan

    out = {}
    for g in (52, 104):
        s = M.fdm27(g, g, g)
        n = s.shape[0]
        A = to_csr(s, device=dev)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                             .astype(np.float32)).to(dev)
        out[f"{g}^3"] = lambda A=A, x=x, n=n: scs_spmv_from_plan(A.plan, x, nrows=n)
    return out


if __name__ == "__main__":
    run(__file__, calls, "scs_", __doc__)
