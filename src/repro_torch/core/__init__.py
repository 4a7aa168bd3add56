"""Morpheus in PyTorch: the sparse-format abstraction (the paper's core).

Public API (the ported part of ``repro.core``):
    operator:  SparseOperator facade (A @ x, A.asformat, A.tune) +
               ExecutionPolicy / use_policy / use_backend backend selection
    formats:   COO, CSR, DIA, ELL, SELL, BSR, Dense containers of tensors
    convert:   from_dense, convert, to_coo/to_csr/to_dia/to_ell/to_sell/to_bsr,
               from_reference
    spmv/spmm: policy-dispatched sparse mat-vec / mat-mat
    autotune:  run-first (format, backend) auto-tuner -> SparseOperator
    features:  structural MatrixFeatures extraction (host-side numpy)
    health:    per-DispatchKey failure counters under dispatch

Not ported yet (ROADMAP queue 1): select, registry, dynamic, distributed.
"""
from .errors import (
    AdmissionError,
    BackendUnsupportedError,
    InjectedFault,
    KernelExecutionError,
    ResilienceError,
    SolverDivergenceError,
    SparseInputError,
    validate_container,
    validate_rhs,
)
from .formats import (
    BSR, COO, CSR, DIA, ELL, SELL, Dense, KernelPlan, format_class, registered_formats,
    resolve_device,
)
from .health import HealthRegistry, KeyHealth, use_health
from .health import registry as health_registry
from .convert import (
    convert, from_dense, from_reference, to_bsr, to_coo, to_csr, to_dia, to_ell, to_sell,
)
from .operator import (
    DEFAULT_POLICY,
    ExecutionPolicy,
    SparseOperator,
    as_operator,
    current_policy,
    policy_for_impl,
    use_backend,
    use_policy,
)
from .spmv import (
    DispatchKey,
    available_impls,
    dispatch_table,
    masked_spmv,
    register_masked_spmv,
    register_spmm,
    register_spmv,
    select_spmv,
    spmm,
    spmv,
)
from .autotune import TuneResult, autotune_spmv, structural_skip
from .features import MatrixFeatures, extract_features

__all__ = [
    "BSR", "COO", "CSR", "DIA", "ELL", "SELL", "Dense", "KernelPlan",
    "format_class", "registered_formats", "resolve_device",
    "convert", "from_dense", "from_reference", "to_bsr", "to_coo", "to_csr",
    "to_dia", "to_ell", "to_sell",
    "DEFAULT_POLICY", "ExecutionPolicy", "SparseOperator", "as_operator",
    "current_policy", "policy_for_impl", "use_backend", "use_policy",
    "BackendUnsupportedError", "DispatchKey", "available_impls", "dispatch_table",
    "masked_spmv", "register_masked_spmv",
    "register_spmm", "register_spmv", "select_spmv", "spmm", "spmv",
    "TuneResult", "autotune_spmv", "structural_skip",
    "MatrixFeatures", "extract_features",
    "AdmissionError", "InjectedFault", "KernelExecutionError",
    "ResilienceError", "SolverDivergenceError", "SparseInputError",
    "validate_container", "validate_rhs",
    "HealthRegistry", "KeyHealth", "health_registry", "use_health",
]
