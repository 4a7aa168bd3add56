"""The port's kernels: each plain PyTorch version against the JAX kernel on
the same numpy inputs (here, on the CPU), and each CUDA kernel against its
plain version on the card (``-m cuda``; skipped without one).

The JAX side runs as the reference's own tests run it on a CPU:
``scs_spmv`` and ``dia_spmv_tiled`` in Pallas interpret mode. The resident
``dia_spmv`` Pallas kernel does not run on this JAX (``pl.load``, ROADMAP
queue 3), so its oracles are ``repro.kernels.ref.dia_spmv_ref`` and the
reference's dia plain backend.

Tolerances: f32 ``rtol=2e-4`` with an atol of ``2e-4 * ||y||_inf`` (sums
reassociated); bf16/f16 ``8 * eps(storage) * max-row-nnz`` (the conformance
grid's rule). int8/int16 plans must give the int32 result bit for bit.

The JAX package is imported inside the tests that use it, so this file
also runs where only PyTorch is installed (the card's machine).
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.dia_spmv import (dia_spmv, dia_spmv_plain, dia_spmv_tiled,
                                          dia_spmv_tiled_plain)
from repro_torch.kernels.sell_spmv import scs_spmv, scs_spmv_from_plan, scs_spmv_plain

tconv = importlib.import_module("repro_torch.core.convert")

SHAPES = [(32, 32), (100, 100), (257, 129), (129, 300)]
DTYPES = ["float32", "bfloat16", "float16"]


def _mat(n, m, seed, kind="mixed"):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    if kind == "banded":
        diags, offs = [], []
        for off in (-7, -3, -1, 0, 1, 2, 5):
            length = min(n, m - off) - max(0, -off)
            if length > 0:
                diags.append(rng.standard_normal(length))
                offs.append(off)
        return sp.diags(diags, offs, shape=(n, m), format="csr")
    mat = sp.random(n, m, density=0.05, random_state=rng, format="csr")
    mat.data = rng.standard_normal(len(mat.data))
    return mat


def _x(m, seed=1):
    return np.random.default_rng(seed).standard_normal(m).astype(np.float32)


def _tol(dtype, s):
    if dtype == "float32":
        return None
    rownnz = int(np.diff(s.tocsr().indptr).max())
    eps = float(torch.finfo(getattr(torch, dtype)).eps)
    return 8 * eps * rownnz


def _close(got, want, tol=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if tol is None:
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-4 * max(1.0, float(np.abs(want).max())))
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture
def jax_ref():
    """The reference package, or a skip where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    return {"jnp": jnp,
            "convert": importlib.import_module("repro.core.convert"),
            "sell": importlib.import_module("repro.kernels.sell_spmv"),
            "dia": importlib.import_module("repro.kernels.dia_spmv"),
            "ref": importlib.import_module("repro.kernels.ref"),
            "spmv": importlib.import_module("repro.core.spmv")}


def _jax_dtype(jnp, name):
    return jnp.dtype(name)


# ----------------------------------------------------------- scs_spmv (CPU) ----


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("col_tile", [None, 64])
def test_scs_plain_matches_pallas_interpret(jax_ref, shape, dtype, col_tile):
    """``scs_spmv_plain`` against the Pallas kernel in interpret mode on the
    same plan arrays (resident and tiled plans)."""
    n, m = shape
    s = _mat(n, m, 0)
    x = _x(m)
    jnp = jax_ref["jnp"]
    J = jax_ref["convert"].from_dense(s, "csr", dtype=_jax_dtype(jnp, dtype),
                                      col_tile=col_tile)
    want = jax_ref["sell"].scs_spmv_from_plan(J.plan, jnp.asarray(x), nrows=n,
                                              interpret=True)
    T = tconv.from_dense(s, "csr", dtype=dtype, col_tile=col_tile, device="cpu")
    got = scs_spmv_from_plan(T.plan, torch.from_numpy(x), nrows=n)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), _tol(dtype, s))


@pytest.mark.parametrize("fmt", ["csr", "sell"])
def test_scs_narrow_indices_bit_identical(fmt):
    """int8 and int16 tile-local indices give the int32 result bit for bit."""
    s = _mat(257, 300, 3)
    x = torch.from_numpy(_x(300))
    ys = {}
    for idx in ("int8", "int16", "int32"):
        T = tconv.from_dense(s, fmt, col_tile=96, index_dtype=idx, device="cpu")
        assert T.plan.index_dtype() == getattr(torch, idx)
        ys[idx] = scs_spmv_from_plan(T.plan, x, nrows=257)
    assert torch.equal(ys["int8"], ys["int32"]) and torch.equal(ys["int16"], ys["int32"])


# ----------------------------------------------------------- dia_spmv (CPU) ----


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_plain_matches_reference_oracles(jax_ref, shape, dtype):
    """``dia_spmv_plain`` against ``ref.dia_spmv_ref`` (f32 view of the same
    stored values) and the reference's dia plain backend."""
    n, m = shape
    s = _mat(n, m, 0, "banded")
    x = _x(m)
    jnp = jax_ref["jnp"]
    J = jax_ref["convert"].from_dense(s, "dia", dtype=_jax_dtype(jnp, dtype))
    want_ref = jax_ref["ref"].dia_spmv_ref(J.offsets, J.data.astype(jnp.float32),
                                           jnp.asarray(x), J.shape)
    want_plain = jax_ref["spmv"].dia_spmv_plain(J, jnp.asarray(x))
    T = tconv.from_dense(s, "dia", dtype=dtype, device="cpu")
    got = dia_spmv(T.offsets, T.data, torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want_ref, np.float32), _tol(dtype, s))
    _close(got.float().numpy(), np.asarray(want_plain, np.float32), _tol(dtype, s))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_tiled_plain_matches_pallas_interpret(jax_ref, shape, dtype):
    n, m = shape
    s = _mat(n, m, 4, "banded")
    x = _x(m)
    jnp = jax_ref["jnp"]
    J = jax_ref["convert"].from_dense(s, "dia", dtype=_jax_dtype(jnp, dtype), col_tile=16)
    offs_t, dat_w = J.plan.arrays
    want = jax_ref["dia"].dia_spmv_tiled(offs_t, dat_w, jnp.asarray(x), nrows=n,
                                         col_tile=16, interpret=True)
    T = tconv.from_dense(s, "dia", dtype=dtype, col_tile=16, device="cpu")
    got = dia_spmv_tiled(*T.plan.arrays, torch.from_numpy(x), nrows=n, col_tile=16)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), _tol(dtype, s))
    # the tiled and the resident plain versions add the same products
    res = dia_spmv(T.offsets, T.data, torch.from_numpy(x))
    _close(got.float().numpy(), res.float().numpy(), _tol(dtype, s))


@pytest.mark.parametrize("col_tile", [None, 16])
def test_masked_dia_is_where_of_unmasked(col_tile):
    """The masked wrapper (mask inside the kernel) equals
    ``where(mask, A @ x, 0)`` exactly, resident and tiled."""
    from repro_torch.core import ExecutionPolicy

    s = _mat(257, 257, 5, "banded")
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False,
                          max_resident_cols=1 << 20 if col_tile is None else 32)
    D = tconv.from_dense(s, "dia", col_tile=col_tile, device="cpu")
    assert ops.cuda_strategy(D, pol) == ("resident" if col_tile is None else "tiled")
    x = torch.from_numpy(_x(257))
    mask = torch.from_numpy(np.random.default_rng(6).random(257) < 0.4)
    got = ops.dia_masked_spmv_cuda(D, x, mask, pol)
    want = torch.where(mask, ops.dia_spmv_cuda(D, x, pol), torch.zeros(()))
    assert torch.equal(got, want)


def test_ref_oracles_match_reference(jax_ref):
    """The torch oracles of ``kernels/ref.py`` against the reference's, on
    the same containers' arrays."""
    from repro_torch.kernels import ref

    jnp = jax_ref["jnp"]
    jr = jax_ref["ref"]
    s = _mat(100, 129, 11)
    x = _x(129)
    X = np.stack([x, _x(129, seed=2)], axis=1)
    for fmt in ("coo", "csr", "dia", "ell", "sell", "bsr"):
        J = jax_ref["convert"].from_dense(s, fmt)
        T = tconv.from_dense(s, fmt, device="cpu")
        _close(ref.spmv_ref(T, torch.from_numpy(x)).numpy(), jr.spmv_ref(J, jnp.asarray(x)))
        _close(ref.spmm_ref(T, torch.from_numpy(X)).numpy(), jr.spmm_ref(J, jnp.asarray(X)))
    E = tconv.from_dense(s, "ell", device="cpu")
    _close(ref.ell_spmv_ref(E.indices, E.data, torch.from_numpy(x)).numpy(), s @ x)
    C = tconv.from_dense(s, "coo", device="cpu")
    _close(ref.coo_spmv_ref(C.row, C.col, C.val, torch.from_numpy(x), 100).numpy(), s @ x)
    D = tconv.from_dense(s, "dia", device="cpu")
    _close(ref.dia_spmv_ref(D.offsets, D.data, torch.from_numpy(x), D.shape).numpy(), s @ x)
    B = tconv.from_dense(s, "bsr", device="cpu")
    Xp = torch.zeros(-(-129 // B.bs) * B.bs, 2)
    Xp[:129] = torch.from_numpy(X)
    _close(ref.bsr_spmm_ref(B.bcols, B.blocks, Xp)[:100].numpy(), s @ X)


def test_failed_build_raises_once_and_is_remembered(monkeypatch, tmp_path):
    """A failed nvcc build raises with its output and is not re-run by every
    later launch (a dispatch chain would otherwise rebuild per call)."""
    from repro_torch.kernels import _build

    calls = []

    def failing_compile(out_dir):
        calls.append(out_dir)
        raise RuntimeError("nvcc failed for ['dia_spmv.cu']: error")

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_compile", failing_compile)
    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "_BUILD_ERROR", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.library()
    assert len(calls) == 1
    assert not list(tmp_path.iterdir())  # the half-built directory is gone


# ------------------------------------------------------- on the card (cuda) ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rel_close(y, y_plain, dtype, s):
    _close(y.float().cpu().numpy(), y_plain.float().cpu().numpy(), _tol(dtype, s))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(3000, 5000)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index_dtype", ["int8", "int16", "int32"])
def test_scs_kernel_matches_plain_on_card(cuda, shape, dtype, index_dtype):
    n, m = shape
    s = _mat(n, m, 7)
    T = tconv.from_dense(s, "csr", dtype=dtype, col_tile=96, index_dtype=index_dtype,
                         device=cuda)
    x = torch.from_numpy(_x(m)).to(cuda)
    before = scs_spmv.launches
    y = scs_spmv_from_plan(T.plan, x, nrows=n)
    assert scs_spmv.launches == before + 1
    ct, ntiles, C, sw, jb, nwin = T.plan.meta
    y_plain = scs_spmv_plain(*T.plan.arrays, x, nrows=n, col_tile=ct, ntiles=ntiles,
                             C=C, sw=sw, jb=jb, nwin=nwin)
    _rel_close(y, y_plain, dtype, s)
    assert torch.equal(y, scs_spmv_from_plan(T.plan, x, nrows=n))  # no atomics
    if index_dtype != "int32":
        T32 = tconv.from_dense(s, "csr", dtype=dtype, col_tile=96, index_dtype="int32",
                               device=cuda)
        assert torch.equal(y, scs_spmv_from_plan(T32.plan, x, nrows=n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(3000, 5000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_kernels_match_plain_on_card(cuda, shape, dtype):
    n, m = shape
    s = _mat(n, m, 8, "banded")
    D = tconv.from_dense(s, "dia", dtype=dtype, col_tile=64, device=cuda)
    x = torch.from_numpy(_x(m)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(9).random(n) < 0.5).to(cuda)
    y = dia_spmv(D.offsets, D.data, x)
    y_plain = dia_spmv_plain(D.offsets, D.data, x)
    # the same products in the same order, multiply and add rounded apart,
    # one rounding to the storage dtype at the end: equal in every dtype
    assert torch.equal(y, y_plain)
    yt = dia_spmv_tiled(*D.plan.arrays, x, nrows=n, col_tile=64)
    yt_plain = dia_spmv_tiled_plain(*D.plan.arrays, x, nrows=n, col_tile=64)
    assert torch.equal(yt, yt_plain)
    ym = dia_spmv(D.offsets, D.data, x, mask=mask)
    assert torch.equal(ym, torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=cuda)))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_mixed_devices(cuda):
    D = tconv.from_dense(_mat(64, 64, 1, "banded"), "dia", device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        dia_spmv(D.offsets, D.data, torch.ones(64))


@pytest.mark.cuda
def test_raising_cuda_kernel_on_card_does_not_fall_back(cuda, monkeypatch):
    """A ``cuda`` kernel that raises on CUDA operands raises out of dispatch,
    though the operator's chain ends in plain."""
    from repro_torch.core import KernelExecutionError, as_operator

    def broken(*args, **kwargs):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(ops, "dia_spmv", broken)
    A = as_operator(_mat(64, 64, 1, "banded"), "dia", device=cuda).using("cuda")
    with pytest.raises(KernelExecutionError):
        A @ torch.ones(64, device=cuda)
