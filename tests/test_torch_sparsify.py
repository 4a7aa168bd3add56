"""``repro_torch.sparsify`` against ``repro.sparsify`` on the same numpy
weights and matrices.

Exact: ``prune_linear_to_bsr``'s block columns, blocks and shape; the
entries ``prune_step`` deletes and the overlay's matrix after it. f32
products: ``bsr_linear`` against the reference's (its products on plain)
and against the masked dense product ``x @ (w * kept)``, at ``rtol=2e-4``
with an atol of ``2e-4 * max|y|`` (the conformance grid's f32 rule: sums
reassociated).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro import sparsify as jsparsify
from repro.core import as_operator as jas_operator

from repro_torch import sparsify
from repro_torch.core import as_operator, use_backend


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=2e-4,
                               atol=2e-4 * max(1.0, float(np.abs(want).max())))


def _kept_dense(A):
    """The dense (out, in) matrix the pruned container holds."""
    return A.to_dense().numpy()


@pytest.mark.parametrize("shape,density,bs", [((96, 64), 0.25, 32), ((100, 70), 0.5, 16),
                                              ((64, 48), 0.02, 8), ((40, 40), 1.0, 8)])
def test_prune_linear_to_bsr_arrays_exact(shape, density, bs):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    J = jsparsify.prune_linear_to_bsr(jnp.asarray(w), density=density, bs=bs)
    T = sparsify.prune_linear_to_bsr(w, density=density, bs=bs, device="cpu")
    assert T.shape == tuple(J.shape) == (shape[1], shape[0])
    assert np.array_equal(T.bcols.numpy(), np.asarray(J.bcols))
    assert np.array_equal(T.blocks.numpy(), np.asarray(J.blocks))
    assert T.bcols.dtype == torch.int32 and T.blocks.dtype == torch.float32
    T2 = sparsify.prune_linear_to_bsr(torch.from_numpy(w), density=density, bs=bs,
                                      device="cpu")
    assert torch.equal(T2.blocks, T.blocks) and torch.equal(T2.bcols, T.bcols)


@pytest.mark.parametrize("lead", [(5,), (2, 3), (1,)])
@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_bsr_linear(lead, impl):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    x = rng.standard_normal(lead + (64,)).astype(np.float32)
    J = jsparsify.prune_linear_to_bsr(jnp.asarray(w), density=0.3, bs=16)
    T = sparsify.prune_linear_to_bsr(w, density=0.3, bs=16, device="cpu")
    want = jsparsify.bsr_linear(J, jnp.asarray(x), impl="plain")
    got = sparsify.bsr_linear(T, torch.from_numpy(x), impl=impl)
    assert got.shape == lead + (96,)
    _close(got.numpy(), want)
    _close(got.numpy(), x @ _kept_dense(T).T)


@pytest.mark.parametrize("fraction", [0.1, 0.35, 1.0])
@pytest.mark.parametrize("fmt", ["csr", "coo", "ell"])
def test_prune_step_deletes_what_the_reference_deletes(fraction, fmt):
    """Two sweeps through each package's overlay: the same count each
    time and, after each, the same merged matrix bit for bit; ``A @ x``
    of the port's overlay then equals the merged matrix's product."""
    rng = np.random.default_rng(2)
    s = sp.random(60, 50, density=0.1, random_state=rng, format="csr", dtype=np.float32)
    s.data = rng.standard_normal(s.nnz).astype(np.float32)
    jov = jas_operator(s, fmt).mutable()
    tov = as_operator(s, fmt, device="cpu").mutable()
    for _ in range(2):
        assert sparsify.prune_step(tov, fraction) == jsparsify.prune_step(jov, fraction)
        a, b = tov.to_scipy(), jov.to_scipy()
        assert a.shape == b.shape
        assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.data, b.data)
    x = rng.standard_normal(50).astype(np.float32)
    with use_backend("plain"):
        _close((tov @ torch.from_numpy(x)).numpy(), tov.to_scipy() @ x)
    with pytest.raises(ValueError):
        sparsify.prune_step(tov, 0.0)
