"""Corpus loader: a directory of ``.mtx`` files as a labeled matrix suite.

The port's own copy of ``repro.io.corpus`` (same names, same order, same
matrices).

``iter_corpus(root)`` walks a directory tree and yields ``(name, csr)``
pairs in the exact shape of ``repro_torch.core.matrices.suite()``, so a
consumer of the synthetic suite (the run-first tuner, ``chip_smoke.py``'s
Matrix Market phase) works unchanged on real SuiteSparse downloads.
Iteration order is **deterministic**: files sort by their
POSIX-style relative path, so corpus accuracy numbers are reproducible
across machines and Python versions (the same guarantee
``matrices.suite()`` makes for the synthetic suite).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

import scipy.sparse as sp

from .matrix_market import MatrixMarketError, mmread

EXTENSIONS = (".mtx", ".mtx.gz")


def corpus_paths(root: str | os.PathLike) -> List[str]:
    """Matrix files under ``root``, sorted by relative POSIX path."""
    root = os.fspath(root)
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if name.endswith(EXTENSIONS):
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                out.append(rel.replace(os.sep, "/"))
    return sorted(out)


def matrix_name(relpath: str) -> str:
    """Suite-style label of one corpus file (relative path, extension
    stripped, separators flattened)."""
    name = relpath
    for ext in EXTENSIONS:
        if name.endswith(ext):
            name = name[: -len(ext)]
            break
    return name.replace("/", "_")


def iter_corpus(root: str | os.PathLike,
                strict: bool = True) -> Iterator[Tuple[str, sp.csr_matrix]]:
    """Yield ``(name, csr_matrix)`` for every ``.mtx``/``.mtx.gz`` under
    ``root``, in deterministic (sorted relative path) order.

    Args:
        root: corpus directory (searched recursively).
        strict: raise on an unreadable/unsupported file (default); with
            ``strict=False`` such files are skipped silently — useful when
            pointing at a raw SuiteSparse download that mixes in complex
            matrices, which :func:`~repro_torch.io.matrix_market.mmread` rejects.

    Yields:
        The same ``(label, scipy.sparse.csr_matrix)`` pairs
        ``matrices.suite()`` yields, float32-convertible, duplicates summed.

    Example:
        >>> import os, tempfile, scipy.sparse as sp
        >>> from repro_torch.io import mmwrite
        >>> d = tempfile.mkdtemp()
        >>> mmwrite(os.path.join(d, "b.mtx"), sp.eye(3, format="csr"))
        >>> mmwrite(os.path.join(d, "a.mtx"), sp.eye(2, format="csr"))
        >>> [name for name, _ in iter_corpus(d)]  # sorted, deterministic
        ['a', 'b']
    """
    root = os.fspath(root)
    for rel in corpus_paths(root):
        path = os.path.join(root, rel.replace("/", os.sep))
        try:
            m = mmread(path)
        except (MatrixMarketError, OSError, ValueError):
            if strict:
                raise
            continue
        s = m.tocsr() if sp.issparse(m) else sp.csr_matrix(m)
        s.sum_duplicates()
        s.eliminate_zeros()  # features/guards operate on logical nonzeros
        yield matrix_name(rel), s.astype("float64")


def corpus_dict(root: str | os.PathLike,
                strict: bool = True) -> Dict[str, sp.csr_matrix]:
    """``dict(iter_corpus(root))`` — the ``suite_dict`` analogue."""
    return dict(iter_corpus(root, strict=strict))
