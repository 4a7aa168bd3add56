"""The reference's conformance grids, run on the card: every registered
``cuda`` cell of the port against the container's own ``to_dense()``
oracle, at the reference's tolerances (``tests/test_conformance.py``).

  - f32 (``_S``, resident): ``rtol=2e-4`` with an absolute ``atol=2e-4``;
  - int8/int16 indices (``_PS`` under a resident cap of ``_PCAP`` columns,
    so every plan-carrying format runs tiled): bit for bit the int32 cell;
  - bf16/f16 storage (``_PS``): ``8 * eps(storage) * max-row-nnz``, the
    oracle being the f32 view of the narrow container.

Each cell goes through strict dispatch
(``ExecutionPolicy(backends=("cuda",), allow_fallback=False)``) on CUDA
tensors, for spmv, spmm and masked spmv. The card's machine has no JAX,
so the inputs are made here with the port's own ``repro_torch.core.matrices``
and numpy from the reference's seeds; a CPU test holds them array for
array against the reference grid's. The ``-m cuda`` tests skip without a
card.
"""
import importlib

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import matrices as M
from repro_torch.kernels import ops  # noqa: F401  (registers the cuda backend)

OPS = ("spmv", "spmm", "masked_spmv")
#: The formats with a registered ``cuda`` SpMV entry: the grid's cells.
CUDA_FORMATS = ("bsr", "coo", "csr", "dia", "ell", "sell")
INDEX_POLICIES = ("int16", "int8")
VALUE_POLICIES = ("bfloat16", "float16")

_N = 96
_S = M.banded(_N, 3, seed=0) + M.random_uniform(_N, 0.02, seed=1)
_X = np.random.default_rng(2).standard_normal(_N).astype(np.float32)
_XM = np.random.default_rng(3).standard_normal((_N, 5)).astype(np.float32)
_MASK = np.random.default_rng(4).random(_N) < 0.5

_PN = 64
_PCAP = 32
_PS = (M.banded(_PN, 3, seed=5) + M.random_uniform(_PN, 0.05, seed=6)).tocsr()
_PX = np.random.default_rng(7).standard_normal(_PN).astype(np.float32)
_PXM = np.random.default_rng(8).standard_normal((_PN, 4)).astype(np.float32)
_PMASK = np.random.default_rng(9).random(_PN) < 0.5
_ROWNNZ_MAX = int(np.diff(_PS.indptr).max())

#: Columns of X on the tensor-core path of ``bsr_spmm`` (8 or more).
_WIDE = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _apply(op, A, policy, x, xm, mask, dev):
    if op == "spmv":
        y = T.spmv(A, torch.from_numpy(x).to(dev), policy=policy)
    elif op == "spmm":
        y = T.spmm(A, torch.from_numpy(xm).to(dev), policy=policy)
    else:
        y = T.masked_spmv(A, torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev),
                          policy=policy)
    assert y.device.type == "cuda"
    return y.float().cpu().numpy()


def _strict(**kw):
    return T.ExecutionPolicy(backends=("cuda",), allow_fallback=False, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", CUDA_FORMATS)
@pytest.mark.parametrize("op", OPS)
def test_cuda_conformance_cell_on_card(cuda, op, fmt):
    """Strict cuda dispatch of the f32 cell against the oracle at rtol 2e-4
    and an absolute atol of 2e-4."""
    A = T.from_dense(_S, fmt, device=cuda)
    dense = A.to_dense().float().cpu().numpy()
    got = _apply(op, A, _strict(), _X, _XM, _MASK, cuda)
    want = {"spmv": lambda: dense @ _X, "spmm": lambda: dense @ _XM,
            "masked_spmv": lambda: np.where(_MASK, dense @ _X, 0)}[op]()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _pcontainer(fmt, dev, index_dtype="int32", value_dtype="float32"):
    pol = T.ExecutionPolicy(max_resident_cols=_PCAP, index_dtype=index_dtype,
                            value_dtype=value_dtype)
    kw = dict(pol.storage_kw(fmt))
    if fmt in ("coo", "csr", "dia", "ell", "sell"):
        kw["col_tile"] = pol.col_tile(_PN)
    return T.from_dense(_PS, fmt, device=dev, **kw)


def _papply(op, A, dev, index_dtype="int32", value_dtype="float32"):
    policy = _strict(max_resident_cols=_PCAP, index_dtype=index_dtype,
                     value_dtype=value_dtype)
    return _apply(op, A, policy, _PX, _PXM, _PMASK, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("idx", INDEX_POLICIES)
@pytest.mark.parametrize("fmt", CUDA_FORMATS)
@pytest.mark.parametrize("op", OPS)
def test_cuda_compressed_index_cell_bit_identical_on_card(cuda, op, fmt, idx):
    """A container built under a narrow index policy gives the int32
    build's result bit for bit (plans tiled under the cap)."""
    base = _papply(op, _pcontainer(fmt, cuda), cuda)
    got = _papply(op, _pcontainer(fmt, cuda, idx), cuda, index_dtype=idx)
    np.testing.assert_array_equal(got, base)


@pytest.mark.cuda
@pytest.mark.parametrize("vdt", VALUE_POLICIES)
@pytest.mark.parametrize("fmt", CUDA_FORMATS)
@pytest.mark.parametrize("op", OPS)
def test_cuda_narrow_value_cell_within_scaled_tolerance_on_card(cuda, op, fmt, vdt):
    """Narrow storage against the f32 view of its own container within
    ``8 * eps(storage) * max-row-nnz``."""
    A = _pcontainer(fmt, cuda, value_dtype=vdt)
    assert A.dtype == getattr(torch, vdt)
    dense = A.to_dense().float().cpu().numpy()
    got = _papply(op, A, cuda, value_dtype=vdt)
    tol = 8 * float(torch.finfo(getattr(torch, vdt)).eps) * _ROWNNZ_MAX
    want = {"spmv": lambda: dense @ _PX, "spmm": lambda: dense @ _PXM,
            "masked_spmv": lambda: np.where(_PMASK, dense @ _PX, 0)}[op]()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["S", "PS"])
def test_bsr_tensor_core_spmm_within_grid_tolerance_on_card(cuda, grid):
    """The grid's spmm has fewer than 8 columns, so it runs ``bsr_spmm`` on
    the CUDA cores; at 128 columns the kernel multiplies on the tensor
    cores (3xTF32), held here to the same f32 tolerance on both matrices."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_path

    s = _S if grid == "S" else _PS
    A = T.from_dense(s, "bsr", device=cuda)
    assert bsr_spmm_path(A.bs, _WIDE) == "tensor-core"
    X = np.random.default_rng(10).standard_normal((s.shape[1], _WIDE)).astype(np.float32)
    got = T.spmm(A, torch.from_numpy(X).to(cuda), policy=_strict()).cpu().numpy()
    np.testing.assert_allclose(got, A.to_dense().float().cpu().numpy() @ X,
                               rtol=2e-4, atol=2e-4)


def test_cuda_grid_covers_every_registered_cuda_entry():
    """The twin of the reference's ``test_grid_covers_every_registered_spmv_entry``:
    the cells of this file are exactly the port's registered ``cuda`` SpMV
    entries, and every masked or SpMM ``cuda`` entry has a cell."""
    spmv = {k.format for k in T.dispatch_table("spmv") if k.backend == "cuda"}
    assert set(CUDA_FORMATS) == spmv, (
        f"grid/table drift: only-in-grid={set(CUDA_FORMATS) - spmv}, "
        f"only-in-table={spmv - set(CUDA_FORMATS)}")
    for table in ("masked_spmv", "spmm"):
        assert {k.format for k in T.dispatch_table(table) if k.backend == "cuda"} <= spmv


def test_cuda_grid_inputs_equal_the_reference_grid():
    """The inputs made here with the port's generators equal the reference
    grid's ``_S, _X, _XM, _MASK, _PS, _PX, _PXM, _PMASK`` array for array."""
    pytest.importorskip("jax")
    ref = importlib.import_module("test_conformance")
    for name in ("_S", "_PS"):
        mine, theirs = globals()[name].tocsr(), getattr(ref, name).tocsr()
        assert mine.shape == theirs.shape
        for attr in ("indptr", "indices", "data"):
            a, b = getattr(mine, attr), getattr(theirs, attr)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, attr)
    for name in ("_X", "_XM", "_MASK", "_PX", "_PXM", "_PMASK"):
        a, b = globals()[name], getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert (_N, _PN, _PCAP, _ROWNNZ_MAX) == (ref._N, ref._PN, ref._PCAP, ref._ROWNNZ_MAX)
