"""Matrix I/O: MatrixMarket files and directory corpora.

The port's copy of ``repro.io`` (numpy and scipy only; no JAX).

Public API:
    matrix_market: ``mmread`` / ``mmwrite`` — the NIST exchange format
        (pattern + symmetric expansion, complex rejected), bit-for-bit
        compatible with ``scipy.io.mmread`` on scipy-written real files
    corpus: ``iter_corpus`` / ``corpus_dict`` — a directory of ``.mtx``
        files as a deterministic ``matrices.suite()``-shaped collection
"""
from .corpus import corpus_dict, corpus_paths, iter_corpus, matrix_name
from .matrix_market import MatrixMarketError, mmread, mmwrite

__all__ = [
    "MatrixMarketError", "mmread", "mmwrite",
    "corpus_dict", "corpus_paths", "iter_corpus", "matrix_name",
]
