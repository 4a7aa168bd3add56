"""The port's dispatch against the JAX reference: the conformance grid, the
strategy choice of the ``cuda`` backend, and the chain/health semantics the
reference's resilience lane defines.

Tolerances: f32 cells use ``rtol=2e-4`` with an atol of ``2e-4 * ||y||_inf``
(the two packages sum a row's products in different orders); bf16/f16
storage uses ``8 * eps(storage) * max-row-nnz`` (``tests/test_conformance.py``:
one rounding per stored entry, with headroom).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import matrices as M
from repro.kernels import ops as jops

import repro_torch.core as T
from repro_torch.core import DispatchKey
from repro_torch.core.health import HealthRegistry, use_health
from repro_torch.kernels import ops as tops

tspmv = importlib.import_module("repro_torch.core.spmv")
tconv = importlib.import_module("repro_torch.core.convert")

FORMATS = ("coo", "csr", "dia", "ell", "sell", "bsr", "dense")
OPS = ("spmv", "spmm", "masked_spmv")

_N = 96
_S = (M.banded(_N, 3, seed=0) + M.random_uniform(_N, 0.02, seed=1)).tocsr()
_X = np.random.default_rng(2).standard_normal(_N).astype(np.float32)
_XM = np.random.default_rng(3).standard_normal((_N, 5)).astype(np.float32)
_MASK = np.random.default_rng(4).random(_N) < 0.5


def _apply_jax(op, A, policy, x, xm, mask):
    if op == "spmv":
        return np.asarray(J.spmv(A, jnp.asarray(x), policy=policy), np.float32)
    if op == "spmm":
        return np.asarray(J.spmm(A, jnp.asarray(xm), policy=policy), np.float32)
    return np.asarray(J.masked_spmv(A, jnp.asarray(x), jnp.asarray(mask),
                                    policy=policy), np.float32)


def _apply_torch(op, A, policy, x, xm, mask):
    if op == "spmv":
        y = T.spmv(A, torch.from_numpy(x), policy=policy)
    elif op == "spmm":
        y = T.spmm(A, torch.from_numpy(xm), policy=policy)
    else:
        y = T.masked_spmv(A, torch.from_numpy(x), torch.from_numpy(mask), policy=policy)
    return y.float().numpy()


def _close(got, want, rtol=2e-4):
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _cells():
    for op in OPS:
        for fmt in FORMATS:
            backends = ["plain", "dense"]
            if DispatchKey(fmt, "cuda") in T.dispatch_table("spmv"):
                backends.append("cuda")
            for b in backends:
                yield pytest.param(op, fmt, b, id=f"{op}-{fmt}-{b}")


@pytest.mark.parametrize("op,fmt,backend", list(_cells()))
def test_conformance_cell_matches_reference(op, fmt, backend):
    """Strict (no-fallback) dispatch of each cell against the reference's
    plain backend on the same matrix; the ``cuda`` cells run the kernels'
    plain versions here (tensors on the CPU)."""
    A_t = T.from_dense(_S, fmt, device="cpu")
    A_j = J.from_dense(_S, fmt)
    pol_t = T.ExecutionPolicy(backends=(backend,), allow_fallback=False)
    pol_j = J.ExecutionPolicy(backends=("plain" if backend == "cuda" else backend,),
                              allow_fallback=False)
    got = _apply_torch(op, A_t, pol_t, _X, _XM, _MASK)
    want = _apply_jax(op, A_j, pol_j, _X, _XM, _MASK)
    _close(got, want)
    if op == "masked_spmv":
        assert (got[~_MASK] == 0).all()


_PN, _PCAP = 64, 32
_PS = (M.banded(_PN, 3, seed=5) + M.random_uniform(_PN, 0.05, seed=6)).tocsr()
_PX = np.random.default_rng(7).standard_normal(_PN).astype(np.float32)
_PXM = np.random.default_rng(8).standard_normal((_PN, 4)).astype(np.float32)
_PMASK = np.random.default_rng(9).random(_PN) < 0.5
_ROWNNZ_MAX = int(np.diff(_PS.indptr).max())


def _pcontainer(fmt, index_dtype="int32", value_dtype="float32"):
    pol = T.ExecutionPolicy(max_resident_cols=_PCAP, index_dtype=index_dtype,
                            value_dtype=value_dtype)
    kw = dict(pol.storage_kw(fmt))
    if fmt in ("coo", "csr", "dia", "ell", "sell"):
        kw["col_tile"] = pol.col_tile(_PN)
    return T.from_dense(_PS, fmt, device="cpu", **kw), pol


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("fmt", ["csr", "sell", "dia", "ell", "coo"])
@pytest.mark.parametrize("idx", ["int16", "int8"])
def test_cuda_compressed_index_bit_identical(op, fmt, idx):
    """Tiled plans with int8/int16 indices give the int32 result bit for bit."""
    base, pol = _pcontainer(fmt, "int32")
    got, pol_n = _pcontainer(fmt, idx)
    assert tops.cuda_strategy(base, pol) == "tiled"
    strict = dict(backends=("cuda",), allow_fallback=False)
    np.testing.assert_array_equal(
        _apply_torch(op, got, pol_n.replace(**strict), _PX, _PXM, _PMASK),
        _apply_torch(op, base, pol.replace(**strict), _PX, _PXM, _PMASK))


_NARROW_CELLS = [(op, fmt, backend, vdt)
                 for op in OPS for vdt in ("bfloat16", "float16")
                 for fmt, backend in [("csr", "plain"), ("sell", "plain"),
                                      ("dia", "plain"), ("coo", "plain"),
                                      ("ell", "plain"), ("csr", "cuda"),
                                      ("sell", "cuda"), ("dia", "cuda"),
                                      ("ell", "cuda"), ("coo", "cuda")]]


@pytest.mark.parametrize("op,fmt,backend,vdt", _NARROW_CELLS)
def test_narrow_value_cell_within_scaled_tolerance(op, fmt, backend, vdt):
    """Narrow storage matches the f32 view of its own container within
    ``8 * eps(storage) * max-row-nnz``."""
    A, pol = _pcontainer(fmt, "int32", vdt)
    assert A.dtype == getattr(torch, vdt)
    dense = A.to_dense().float().numpy()
    got = _apply_torch(op, A, pol.replace(backends=(backend,), allow_fallback=False),
                       _PX, _PXM, _PMASK)
    tol = 8 * float(torch.finfo(getattr(torch, vdt)).eps) * _ROWNNZ_MAX
    ref = {"spmv": dense @ _PX, "spmm": dense @ _PXM,
           "masked_spmv": np.where(_PMASK, dense @ _PX, 0)}[op]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("max_resident_cols", [1 << 20, 256, 64, 16])
def test_cuda_strategy_equals_pallas_strategy(max_resident_cols, suite_small):
    """For the same matrix, plans and limits both packages pick the same
    strategy — resident, tiled, block or none — format by format."""
    pol_t = T.ExecutionPolicy(max_resident_cols=max_resident_cols)
    pol_j = J.ExecutionPolicy(max_resident_cols=max_resident_cols)
    assert pol_t.resident_cols() == pol_j.resident_cols()
    mats = dict(suite_small)
    mats["fdm27_8x8x8"] = M.fdm27(8, 8, 8)
    for name, s in mats.items():
        for fmt in ("coo", "csr", "dia", "ell", "sell", "bsr"):
            kw = {}
            if fmt != "bsr":
                kw["col_tile"] = tconv.col_tile_for_policy(
                    fmt, s.shape[1], pol_t.col_tile(s.shape[1]))
            A_t = T.from_dense(s, fmt, device="cpu", **kw)
            A_j = J.from_dense(s, fmt, **kw)
            assert tops.cuda_strategy(A_t, pol_t) == jops.pallas_strategy(A_j, pol_j), \
                (name, fmt, max_resident_cols)


def test_tiled_strategy_is_reached():
    s = M.fdm27(8, 8, 8)
    pol = T.ExecutionPolicy(max_resident_cols=64)
    for fmt in ("csr", "sell", "dia", "ell", "coo"):
        A = T.from_dense(s, fmt, device="cpu", col_tile=pol.col_tile(512))
        assert tops.cuda_strategy(A, pol) == "tiled", fmt


@pytest.fixture
def failing_calls(monkeypatch):
    """Make selected keys' kernels raise and record every attempted key."""
    state = {"fail": set(), "attempts": []}
    orig = tspmv.KernelEntry.call

    def call(self, A, *operands, policy):
        state["attempts"].append(self.key)
        if self.key in state["fail"]:
            raise RuntimeError(f"forced failure for {self.key}")
        return orig(self, A, *operands, policy=policy)

    monkeypatch.setattr(tspmv.KernelEntry, "call", call)
    return state


def test_raising_entry_falls_to_next_exactly_once(failing_calls):
    """A raising chain entry records one failure and hands control to the
    next entry exactly once; the result is the next entry's."""
    A = T.from_dense(_S, "csr", device="cpu")
    x = torch.from_numpy(_X)
    key = DispatchKey("csr", "cuda")
    failing_calls["fail"].add(key)
    reg = HealthRegistry()
    with use_health(reg):
        y = T.spmv(A, x, policy=T.ExecutionPolicy(backends=("cuda", "plain")))
    assert failing_calls["attempts"] == [key, DispatchKey("csr", "plain")]
    assert reg.snapshot()["keys"]["csr/cuda"]["failures"] == 1
    np.testing.assert_array_equal(
        y.numpy(), T.spmv(A, x, policy=T.ExecutionPolicy()).numpy())
    # strict policy: no fallback, the failure is wrapped
    with use_health(HealthRegistry()), pytest.raises(T.KernelExecutionError):
        T.spmv(A, x, policy=T.ExecutionPolicy(backends=("cuda",), allow_fallback=False))


def test_quarantined_key_is_ordered_last(failing_calls):
    A = T.from_dense(_S, "dia", device="cpu")
    x = torch.from_numpy(_X)
    key = DispatchKey("dia", "cuda")
    failing_calls["fail"].add(key)
    reg = HealthRegistry(failure_threshold=2, cooldown_s=1e9)
    pol = T.ExecutionPolicy(backends=("cuda", "plain"))
    with use_health(reg):
        T.spmv(A, x, policy=pol)
        T.spmv(A, x, policy=pol)
        assert reg.quarantined(key) and reg.blocked(key)
        failing_calls["attempts"].clear()
        T.spmv(A, x, policy=pol)
    assert failing_calls["attempts"] == [DispatchKey("dia", "plain")]


def test_autotune_race_records_a_raising_cuda_kernel(monkeypatch):
    """The audit chip_smoke.py relies on: when a ``cuda`` kernel raises in an
    ``autotune_spmv`` race, the race still reports a time for the key (the
    plain fallback ran under its label), and the failure lands in the health
    snapshot — which is where a caller must look."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(tops, "dia_spmv_from_container", broken)
    reg = HealthRegistry()
    with use_health(reg):
        res = T.autotune_spmv(M.fdm27(4, 4, 4), device="cpu", iters=2, warmup=1,
                              candidates=[("dia", "cuda"), ("csr", "cuda")])
    assert ("dia", "cuda") in res.table
    assert not [sk for sk in res.skipped if sk[2].startswith("error:")]
    keys = reg.snapshot()["keys"]
    assert keys["dia/cuda"]["failures"] >= 1
    assert "csr/cuda" not in keys or keys["csr/cuda"]["failures"] == 0


@pytest.fixture
def on_card(monkeypatch):
    """Dispatch as for operands on a CUDA device (the rule reads only
    ``_on_card``; the tensors stay on the host, where the kernels' plain
    versions run)."""
    monkeypatch.setattr(tspmv, "_on_card", lambda x: True)


@pytest.mark.parametrize("op", OPS)
def test_raising_cuda_kernel_on_card_raises(failing_calls, on_card, op):
    """On the card a raising ``cuda`` kernel does not give way to plain,
    though the chain holds plain: dispatch raises ``KernelExecutionError``
    after that one attempt, and the failure is recorded."""
    A = T.from_dense(_S, "dia", device="cpu")
    key = DispatchKey("dia", "cuda")
    failing_calls["fail"].add(key)
    reg = HealthRegistry()
    with use_health(reg), pytest.raises(T.KernelExecutionError):
        _apply_torch(op, A, T.ExecutionPolicy(backends=("cuda", "plain")), _X, _XM, _MASK)
    assert failing_calls["attempts"] == [key]
    assert reg.snapshot()["keys"]["dia/cuda"]["failures"] == 1


def test_quarantined_cuda_key_on_card_is_not_passed_over(failing_calls, on_card):
    """On the card a quarantined ``cuda`` key keeps its place in the chain:
    it runs (here it raises again) instead of plain running in its stead."""
    A = T.from_dense(_S, "dia", device="cpu")
    x = torch.from_numpy(_X)
    key = DispatchKey("dia", "cuda")
    failing_calls["fail"].add(key)
    reg = HealthRegistry(failure_threshold=1, cooldown_s=1e9)
    pol = T.ExecutionPolicy(backends=("cuda", "plain"))
    with use_health(reg):
        with pytest.raises(T.KernelExecutionError):
            T.spmv(A, x, policy=pol)
        assert reg.blocked(key)
        failing_calls["attempts"].clear()
        with pytest.raises(T.KernelExecutionError):
            T.spmv(A, x, policy=pol)
    assert failing_calls["attempts"] == [key]


def test_autotune_race_on_card_lists_a_raising_cuda_kernel(monkeypatch, on_card):
    """On the card the race times no plain code under a ``cuda`` label: a
    raising kernel's key is listed as an error and gets no time."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(tops, "dia_spmv_from_container", broken)
    with use_health(HealthRegistry()):
        res = T.autotune_spmv(M.fdm27(4, 4, 4), device="cpu", iters=2, warmup=1,
                              candidates=[("dia", "cuda"), ("csr", "cuda")])
    assert ("dia", "cuda") not in res.table and ("csr", "cuda") in res.table
    assert ("dia", "cuda", "error: KernelExecutionError") in res.skipped


def test_unported_formats_are_listed_not_raced():
    """Every sparse format has a ``cuda`` kernel now: none is listed as
    "impl not registered", and ell, coo and bsr are raced."""
    res = T.autotune_spmv(M.fdm27(4, 4, 4), device="cpu", iters=1, warmup=0,
                          candidates=[("ell", "cuda"), ("coo", "cuda"),
                                      ("bsr", "cuda"), ("csr", "plain")])
    assert not [sk for sk in res.skipped if sk[2] == "impl not registered"]
    assert {("ell", "cuda"), ("coo", "cuda"), ("bsr", "cuda")} <= set(res.table)


#: A policy under which coo/cuda rejects fdm27(4, 4, 4): 64 rows exceed the
#: full window, and the 64 columns fit x whole, so no plan is built.
_SMALL_WINDOW = T.ExecutionPolicy(max_onehot_rows=16)


def _race_rejecting_coo():
    A = T.from_dense(M.fdm27(4, 4, 4), "coo", device="cpu")
    assert not tops._coo_ok(A, _SMALL_WINDOW)
    return T.autotune_spmv(M.fdm27(4, 4, 4), device="cpu", iters=1, warmup=0,
                           policy=_SMALL_WINDOW,
                           candidates=[("coo", "cuda"), ("coo", "plain"), ("csr", "cuda")])


def test_autotune_race_on_card_lists_a_rejecting_cuda_key(on_card):
    """On the card a ``cuda`` key whose predicate rejects the container is
    listed as unsupported and gets no time: the chain would have run plain
    under the cuda label."""
    with use_health(HealthRegistry()):
        res = _race_rejecting_coo()
    assert ("coo", "cuda") not in res.table
    assert ("coo", "cuda", "unsupported") in res.skipped
    assert {("coo", "plain"), ("csr", "cuda")} <= set(res.table)


def test_autotune_race_on_host_times_a_rejecting_cuda_key():
    """On the host the reference's semantics stay: the chain
    ``(cuda, plain)`` passes the rejecting entry over, and the race times
    what ran under the cuda label."""
    with use_health(HealthRegistry()):
        res = _race_rejecting_coo()
    assert ("coo", "cuda") in res.table
    assert not [sk for sk in res.skipped if sk[:2] == ("coo", "cuda")]


def test_spmm_columns_equal_spmv_bitwise():
    """SpMM without a native kernel is SpMV per column: column j equals
    ``A @ X[:, j]`` bit for bit (the serving layer's coalescing contract)."""
    for fmt in ("csr", "sell", "dia", "ell", "coo"):
        A = T.as_operator(_S, fmt, device="cpu").using("cuda")
        X = torch.from_numpy(_XM)
        Y = A @ X
        for j in range(X.shape[1]):
            assert torch.equal(Y[:, j], A @ X[:, j].contiguous()), fmt


def test_operator_api_mirrors_reference():
    A = T.as_operator(_S, device="cpu")
    assert (A.format, A.shape) == ("csr", (_N, _N))
    B = A.asformat("dia")
    assert B.format == "dia" and B.asformat("dia") is B
    assert A.asformat("dia") is not None and len(A._cache) == 1
    with T.use_backend("cuda"):
        assert T.current_policy().backends == ("cuda", "plain")
    P = A.tune(mode="predict")  # the "cpu" table: the reference's pick
    J_P = J.as_operator(_S).tune(mode="predict")
    assert (P.format, P.policy.backends[0]) == (
        J_P.format, J_P.policy.backends[0].replace("pallas", "cuda"))
    _close((P @ torch.from_numpy(_X)).numpy(), _S @ _X)
    ov = A.mutable()  # the dynamic-matrix lane (core/dynamic.py)
    assert ov.base is A and ov.ndelta == 0
    ov.set(0, _N - 1, 1.0)
    assert A.refresh(ov, threshold=1e9) is ov.base and ov.ndelta == 0
    tuned = A.tune(candidates=[("csr", "plain"), ("dia", "cuda")], iters=1, warmup=0,
                   device="cpu")
    _close((tuned @ torch.from_numpy(_X)).numpy(), _S @ _X)


@pytest.mark.parametrize("modname", ["repro_torch.core.operator", "repro_torch.core.health",
                                     "repro_torch.core.autotune", "repro_torch.core.features",
                                     "repro_torch.core.select", "repro_torch.core.dynamic",
                                     "repro_torch.solvers.cg", "repro_torch.solvers.mg",
                                     "repro_torch.io.matrix_market", "repro_torch.io.corpus"])
def test_port_doctests(modname):
    import doctest

    res = doctest.testmod(importlib.import_module(modname), verbose=False,
                          optionflags=doctest.NORMALIZE_WHITESPACE)
    assert res.failed == 0 and res.attempted > 0, modname
