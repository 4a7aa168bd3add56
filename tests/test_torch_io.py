"""The port's Matrix Market I/O against the reference's: the same files give
the same arrays and dtypes, the same corpus order, the same writes, and the
same errors. Host-side numpy code, so every comparison is exact."""
import gzip
import io
import os

import numpy as np
import pytest
import scipy.sparse as sp

import repro.io as J
from repro.core import matrices as M

import repro_torch.io as T

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "corpus")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".mtx"))


def _assert_same_matrix(a, b):
    """Equal type, shape, dtype and entries (row, col, val in stored order
    for COO; the arrays themselves for a dense read)."""
    assert type(a) is type(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if sp.issparse(a):
        for name in (("row", "col", "data") if a.format == "coo"
                     else ("indptr", "indices", "data")):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fname", FIXTURE_FILES)
def test_fixture_reads_equal_reference(fname):
    path = os.path.join(FIXTURES, fname)
    _assert_same_matrix(T.mmread(path), J.mmread(path))


def test_iter_corpus_equals_reference():
    """Same names in the same order, and the same CSR arrays."""
    got, want = list(T.iter_corpus(FIXTURES)), list(J.iter_corpus(FIXTURES))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == len(FIXTURE_FILES)
    for (_, a), (_, b) in zip(got, want):
        _assert_same_matrix(a, b)
    assert T.corpus_paths(FIXTURES) == J.corpus_paths(FIXTURES)
    assert T.corpus_dict(FIXTURES).keys() == J.corpus_dict(FIXTURES).keys()


@pytest.mark.parametrize("field,symmetry", [("real", None), ("real", "general"),
                                            ("pattern", None), ("integer", "general")])
def test_mmwrite_text_equals_reference_and_round_trips(field, symmetry):
    s = (M.banded(40, 2, seed=3) + M.banded(40, 2, seed=4).T).tocsr()
    if field == "integer":
        s.data = np.round(s.data * 10)
    bufs = [io.StringIO(), io.StringIO()]
    T.mmwrite(bufs[0], s, comment="port", field=field, symmetry=symmetry)
    J.mmwrite(bufs[1], s, comment="port", field=field, symmetry=symmetry)
    assert bufs[0].getvalue() == bufs[1].getvalue()
    bufs[0].seek(0)
    back = T.mmread(bufs[0])
    want = (s != 0).astype(np.float64) if field == "pattern" else s
    np.testing.assert_array_equal(back.toarray(), want.toarray())


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix coordinate real symmetric\n3 3 3\n1 1 2.0\n2 1 -1.5\n3 2 4.0\n",
    "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 2\n2 1 1.5\n3 1 -2.0\n",
    "%%MatrixMarket matrix coordinate pattern symmetric\n3 3 2\n1 1\n3 2\n",
    "%%MatrixMarket matrix coordinate integer general\n2 2 1\n1 2 9007199254740993\n",
    "%%MatrixMarket matrix array real symmetric\n2 2\n1\n2\n3\n",
    "%%MatrixMarket matrix array real skew-symmetric\n2 2\n5\n",
])
def test_expansion_equals_reference(text):
    """Pattern, symmetric and skew-symmetric expansion, integer fields and
    the array layout read as the reference reads them."""
    _assert_same_matrix(T.mmread(io.StringIO(text)), J.mmread(io.StringIO(text)))


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 2\n",
    "%%MatrixMarket matrix coordinate real hermitian\n1 1 1\n1 1 1\n",
    "%%MatrixMarket matrix coordinate pattern skew-symmetric\n2 2 1\n2 1\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n",
    "not a header\n1 1 1\n",
])
def test_rejections_equal_reference(text):
    """Complex and hermitian matrices, pattern+skew, a short body and an
    index out of range are refused with the reference's message."""
    with pytest.raises(J.MatrixMarketError) as want:
        J.mmread(io.StringIO(text))
    with pytest.raises(T.MatrixMarketError) as got:
        T.mmread(io.StringIO(text))
    assert str(got.value) == str(want.value)


def test_gzip_round_trip_and_corpus(tmp_path):
    m = sp.random(12, 12, density=0.3, random_state=np.random.default_rng(2))
    path = os.path.join(tmp_path, "m.mtx.gz")
    T.mmwrite(path, m)
    with gzip.open(path, "rt") as f:
        assert f.readline().startswith("%%MatrixMarket")
    _assert_same_matrix(T.mmread(path), J.mmread(path))
    assert np.array_equal(T.mmread(path).toarray(), m.toarray())
    assert [n for n, _ in T.iter_corpus(tmp_path)] == ["m"]


def test_mmwrite_accepts_port_containers_and_operators():
    from repro_torch.core import as_operator, from_dense

    s = M.tridiag(32, seed=0)
    for a in (from_dense(s, "dia", dtype="float64", device="cpu"),
              from_dense(s, "ell", dtype="float64", device="cpu"),
              as_operator(s, "coo", device="cpu")):
        buf = io.StringIO()
        T.mmwrite(buf, a)
        buf.seek(0)
        np.testing.assert_allclose(T.mmread(buf).toarray(), s.toarray(), rtol=1e-6,
                                   atol=1e-9)
