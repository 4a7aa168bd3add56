"""Matrix Market (``.mtx``) reader/writer, dependency-light.

The port's own copy of ``repro.io.matrix_market``: pure numpy and scipy,
the same API, and the same arrays and dtypes for the same file. Only the
container conversion of :func:`mmwrite` comes from this package.

The paper evaluates >2100 SuiteSparse matrices, all distributed in the
NIST Matrix Market exchange format; this module lets the repo ingest them
(and ship tiny committed fixtures) without carrying ``scipy.io`` semantics
we do not want. Differences from ``scipy.io.mmread`` are deliberate and
small:

  - **complex matrices are rejected** with a clear error (the kernels are
    real-valued; silently dropping imaginary parts would corrupt results),
    including ``hermitian`` symmetry, which implies a complex field;
  - pattern matrices materialise as value-1.0 entries (what an SpMV over a
    graph adjacency wants);
  - symmetric / skew-symmetric storage is expanded to the full matrix on
    read, exactly once per off-diagonal entry.

On files scipy itself wrote, :func:`mmread` is bit-for-bit identical to
``scipy.io.mmread`` (asserted by the property suite): both parse the same
decimal literals with the same ``float``.
"""
from __future__ import annotations

import gzip
import io
import os
from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp

VALID_FIELDS = ("real", "integer", "pattern")
VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric")

PathOrFile = Union[str, os.PathLike, io.IOBase]


class MatrixMarketError(ValueError):
    """Malformed or unsupported Matrix Market content."""


def _open(source: PathOrFile, mode: str):
    """(stream, should_close). Paths ending in .gz open through gzip."""
    if hasattr(source, "read") or hasattr(source, "write"):
        return source, False
    path = os.fspath(source)
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t"), True
    return open(path, mode), True


def _parse_header(line: str) -> Tuple[str, str, str]:
    parts = line.strip().split()
    if (len(parts) != 5 or parts[0] != "%%MatrixMarket"
            or parts[1].lower() != "matrix"):
        raise MatrixMarketError(f"not a MatrixMarket matrix header: {line!r}")
    layout, field, symmetry = (p.lower() for p in parts[2:])
    if layout not in ("coordinate", "array"):
        raise MatrixMarketError(f"unknown layout {layout!r}")
    if field == "complex" or symmetry == "hermitian":
        raise MatrixMarketError(
            "complex matrices are not supported: this repo's containers and "
            "kernels are real-valued, and silently dropping imaginary parts "
            "would corrupt results — convert the matrix to a real form first")
    if field not in VALID_FIELDS:
        raise MatrixMarketError(f"unknown field {field!r}")
    if symmetry not in VALID_SYMMETRIES:
        raise MatrixMarketError(f"unknown symmetry {symmetry!r}")
    if field == "pattern" and symmetry == "skew-symmetric":
        # the MM spec has no pattern+skew: negating a structure-only entry
        # is meaningless (it would materialise -1.0 "pattern" values)
        raise MatrixMarketError("pattern matrices cannot be skew-symmetric")
    return layout, field, symmetry


def _expand_symmetry(row, col, val, symmetry: str):
    """Mirror the stored (lower-triangular) entries across the diagonal."""
    if symmetry == "general":
        return row, col, val
    off = row != col
    if symmetry == "skew-symmetric" and not np.all(off):
        raise MatrixMarketError("skew-symmetric file stores diagonal entries")
    mval = -val[off] if symmetry == "skew-symmetric" else val[off]
    return (np.concatenate([row, col[off]]),
            np.concatenate([col, row[off]]),
            np.concatenate([val, mval]))


def mmread(source: PathOrFile):
    """Read a Matrix Market file.

    Args:
        source: path (``.mtx`` or ``.mtx.gz``) or text-mode file object.

    Returns:
        ``scipy.sparse.coo_matrix`` for ``coordinate`` files (dtype float64,
        or int64 for ``integer`` fields; ``pattern`` entries read as 1.0),
        ``numpy.ndarray`` for ``array`` files — the scipy.io.mmread shapes.

    Raises:
        MatrixMarketError: malformed content, or a complex/hermitian matrix.

    Example:
        >>> import io, numpy as np
        >>> f = io.StringIO('''%%MatrixMarket matrix coordinate real symmetric
        ... 2 2 2
        ... 1 1 3.0
        ... 2 1 -1.5
        ... ''')
        >>> mmread(f).toarray()
        array([[ 3. , -1.5],
               [-1.5,  0. ]])
    """
    f, close = _open(source, "r")
    try:
        line = f.readline()
        layout, field, symmetry = _parse_header(line)
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        dims = line.split()
        if layout == "coordinate":
            if len(dims) != 3:
                raise MatrixMarketError(f"bad coordinate size line: {line!r}")
            nrows, ncols, nnz = (int(d) for d in dims)
            # vectorised body parse — SuiteSparse-scale files (1e7+ entries)
            # must not pay a Python loop per entry; integer fields parse with
            # an int dtype so values past 2^53 do not round through float64
            try:
                body = np.loadtxt(
                    f, comments="%", ndmin=2,
                    dtype=np.int64 if field == "integer" else np.float64)
            except (ValueError, OverflowError) as e:
                raise MatrixMarketError(f"malformed entry body: {e}") from e
            if body.size == 0:
                body = body.reshape(0, 3 if field != "pattern" else 2)
            if body.shape[0] != nnz:
                raise MatrixMarketError(
                    f"expected {nnz} entries, found {body.shape[0]}")
            want_cols = 2 if field == "pattern" else 3
            if nnz and body.shape[1] < want_cols:
                raise MatrixMarketError(
                    f"{field} entries need {want_cols} columns, "
                    f"got {body.shape[1]}")
            rows = body[:, 0].astype(np.int64) if nnz else np.empty(0, np.int64)
            cols = body[:, 1].astype(np.int64) if nnz else np.empty(0, np.int64)
            vals = (body[:, 2].copy() if field != "pattern" and nnz
                    else np.ones(nnz, np.float64))
            if nnz and (rows.min() < 1 or cols.min() < 1
                        or rows.max() > nrows or cols.max() > ncols):
                raise MatrixMarketError("1-based indices out of range")
            rows -= 1
            cols -= 1
            rows, cols, vals = _expand_symmetry(rows, cols, vals, symmetry)
            if field == "integer":
                vals = vals.astype(np.int64)
            return sp.coo_matrix((vals, (rows, cols)), shape=(nrows, ncols))
        # array layout: column-major dense values
        if len(dims) != 2:
            raise MatrixMarketError(f"bad array size line: {line!r}")
        nrows, ncols = (int(d) for d in dims)
        if field == "pattern":
            raise MatrixMarketError("array layout cannot have a pattern field")
        # integer fields parse as int, like the coordinate path — values past
        # 2^53 must not round through float64
        conv = int if field == "integer" else float
        try:
            raw = [conv(tok) for ln in f.read().split("\n")
                   for tok in ([] if ln.lstrip().startswith("%") else ln.split())]
        except ValueError as e:
            raise MatrixMarketError(f"malformed array body: {e}") from e
        dense = np.zeros((nrows, ncols),
                         np.int64 if field == "integer" else np.float64)
        if symmetry == "general":
            if len(raw) != nrows * ncols:
                raise MatrixMarketError("array entry count mismatch")
            dense = np.asarray(raw, dense.dtype).reshape(ncols, nrows).T.copy()
        else:
            lo = 0 if symmetry == "symmetric" else 1  # skew skips the diagonal
            expected = sum(max(nrows - j - lo, 0) for j in range(ncols))
            if len(raw) != expected:  # checked first: a truncated file must
                # be a clean MatrixMarketError, not an IndexError mid-fill
                raise MatrixMarketError("array entry count mismatch")
            k = 0
            for j in range(ncols):
                for i in range(j + lo, nrows):
                    dense[i, j] = raw[k]
                    k += 1
            mirror = dense.T.copy()
            np.fill_diagonal(mirror, 0)
            dense = dense + (-mirror if symmetry == "skew-symmetric" else mirror)
        return dense
    finally:
        if close:
            f.close()


def _detect_symmetry(coo: sp.coo_matrix) -> str:
    if coo.shape[0] != coo.shape[1]:
        return "general"
    csr = coo.tocsr()
    csr.sum_duplicates()
    if (csr != csr.T).nnz == 0:
        return "symmetric"
    if (csr + csr.T).nnz == 0 and csr.diagonal().max(initial=0.0) == 0.0 \
            and csr.diagonal().min(initial=0.0) == 0.0:
        return "skew-symmetric"
    return "general"


def mmwrite(target: PathOrFile, a, comment: str = "",
            field: Optional[str] = None, symmetry: Optional[str] = None,
            precision: int = 16) -> None:
    """Write ``a`` as a Matrix Market ``coordinate`` file.

    Args:
        target: path (``.gz`` compresses) or text-mode file object.
        a: scipy sparse matrix, dense array, registered container, or
            ``SparseOperator``.
        comment: extra ``%`` comment lines.
        field: ``"real"`` (default) | ``"integer"`` | ``"pattern"`` —
            pattern drops the values, writing structure only.
        symmetry: ``None`` auto-detects (``symmetric`` / ``skew-symmetric``
            for exactly-(anti)symmetric square matrices, else ``general``);
            pass ``"general"`` to force full storage.
        precision: significant digits after the point; the default 16 (17
            significant digits) round-trips float64 bit-for-bit, which the
            property suite relies on.

    Example:
        >>> import io, scipy.sparse as sp
        >>> buf = io.StringIO()
        >>> mmwrite(buf, sp.eye(2, format="csr"), symmetry="general")
        >>> print(buf.getvalue().splitlines()[0])
        %%MatrixMarket matrix coordinate real general
    """
    if hasattr(a, "container"):  # SparseOperator facade
        a = a.container
    if not sp.issparse(a):
        if hasattr(a, "to_dense"):  # registered container
            from repro_torch.core.convert import container_to_scipy

            a = container_to_scipy(a)
        else:
            a = sp.coo_matrix(np.asarray(a))
    coo = a.tocoo()
    coo.sum_duplicates()
    field = field or "real"
    if field not in VALID_FIELDS:
        raise MatrixMarketError(f"unknown field {field!r}")
    if np.iscomplexobj(coo.data):
        raise MatrixMarketError("complex matrices are not supported")
    explicit = symmetry is not None
    symmetry = symmetry if explicit else _detect_symmetry(coo)
    if symmetry not in VALID_SYMMETRIES:
        raise MatrixMarketError(f"unknown symmetry {symmetry!r}")
    if field == "pattern" and symmetry == "skew-symmetric":
        # no pattern+skew in the MM spec (sign needs values): reject an
        # explicit request, downgrade an auto-detection to general
        if explicit:
            raise MatrixMarketError("pattern matrices cannot be skew-symmetric")
        symmetry = "general"

    row, col, val = coo.row, coo.col, coo.data
    if symmetry == "symmetric":
        keep = row >= col  # store the lower triangle once
        row, col, val = row[keep], col[keep], val[keep]
    elif symmetry == "skew-symmetric":
        keep = row > col
        row, col, val = row[keep], col[keep], val[keep]
    order = np.lexsort((row, col))  # column-major, the MM convention
    row, col, val = row[order], col[order], val[order]

    f, close = _open(target, "w")
    try:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        for ln in comment.splitlines():
            f.write(f"%{ln}\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {len(val)}\n")
        # one savetxt call, not a Python f.write per entry — the write path
        # must scale to SuiteSparse-size matrices like the read path does
        ij = np.column_stack([row + 1, col + 1]).astype(np.int64)
        if field == "pattern":
            np.savetxt(f, ij, fmt="%d")
        elif field == "integer":
            np.savetxt(f, np.column_stack([ij, val.astype(np.int64)]), fmt="%d")
        else:
            np.savetxt(f, np.column_stack([ij.astype(np.float64), val]),
                       fmt=["%d", "%d", f"%.{precision}e"])
    finally:
        if close:
            f.close()
