"""Host time of the full-window COO wrapper (coo/cuda) in two trees of the
port, on the card.

  python examples/coo_wrapper_ab.py OLD_TREE NEW_TREE

Calls the dispatch entry ``ops.coo_spmv_cuda`` on the coo containers of
HPCG's 13^3 level (the full window at the default ``max_onehot_rows``) and
of its 26^3 level (under a policy whose ``max_onehot_rows`` takes its
17,576 rows), one process per tree, in alternating rounds;
``examples/_wrapper_ab.py`` says what each round reports. Each process also
times ``13^3 cuSPARSE``, torch's CSR product of the same matrix and x (the
yardstick ``chip_smoke.py`` times as ``library_ms``; the port never makes
it), which is the same code in both trees and so also shows the noise.
Needs a CUDA card and nvcc.
"""
from _wrapper_ab import run


def calls(dev):
    import numpy as np
    import torch

    from repro_torch.core import ExecutionPolicy
    from repro_torch.core import matrices as M
    from repro_torch.core.convert import to_coo
    from repro_torch.kernels import ops

    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False, max_onehot_rows=1 << 15)
    out = {}
    for g in (13, 26):
        s = M.fdm27(g, g, g)
        C = to_coo(s, device=dev)
        assert ops.cuda_strategy(C, pol) == "resident"
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(s.shape[0])
                             .astype(np.float32)).to(dev)
        out[f"{g}^3"] = lambda C=C, x=x: ops.coo_spmv_cuda(C, x, pol)
        if g == 13:
            csr = torch.sparse_csr_tensor(torch.from_numpy(s.indptr.astype(np.int64)),
                                          torch.from_numpy(s.indices.astype(np.int64)),
                                          torch.from_numpy(s.data.astype(np.float32)),
                                          size=s.shape).to(dev)
            out["13^3 cuSPARSE"] = lambda csr=csr, x=x: csr @ x
    return out


if __name__ == "__main__":
    run(__file__, calls, ("coo_rows", "csrmv", "spmv", "cusparse"), __doc__)
