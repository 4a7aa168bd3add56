"""repro_torch — the PyTorch/CUDA port of the Morpheus SpMV library.

The JAX package ``repro`` is the reference; this package has the same
modules, containers, plans and dispatch, in PyTorch, with hand-written CUDA
kernels for Hopper (``sm_90a``) registered as the ``cuda`` backend. It
imports neither ``jax`` nor ``repro``.

Entry points take ``device=`` (default ``"cuda"``; without a card they
raise rather than run on the host). Layout:

    core/     containers, plans, conversion, policy, dispatch, tuner
    kernels/  the CUDA kernels' wrappers (csrc/ holds their sources)
    solvers/  CG, SymGS, multigrid
    apps/     HPCG
"""
