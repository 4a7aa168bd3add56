"""Synthetic matrix suite — offline proxy for the SuiteSparse collection.

The paper evaluates >2100 SuiteSparse matrices. Offline we generate a labeled
suite spanning the sparsity-pattern axes that drive format choice in the
paper: bandedness (DIA country), row-regularity (ELL/CSR country), and
unstructured scatter (COO country). Generators are deterministic in ``seed``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import scipy.sparse as sp


def banded(n: int, band: int = 3, seed: int = 0,
           dtype=np.float64) -> sp.csr_matrix:
    """Banded matrix with ``2*band+1`` dense diagonals (FDM-like)."""
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n) for _ in range(2 * band + 1)]
    offsets = list(range(-band, band + 1))
    return sp.diags(diags, offsets, shape=(n, n),
                    format="csr").astype(dtype, copy=False)


def tridiag(n: int, seed: int = 0, dtype=np.float64) -> sp.csr_matrix:
    return banded(n, 1, seed, dtype=dtype)


def fdm27(nx: int, ny: int, nz: int, dtype=np.float64) -> sp.csr_matrix:
    """HPCG's 27-point stencil on an nx*ny*nz grid: 26 on the diagonal,
    -1 for each of the up-to-26 neighbours (Dirichlet-style truncation).
    Built vectorised so multigrid hierarchies over large grids are cheap."""
    n = nx * ny * nz
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    r = i + nx * (j + ny * k)
    rows, cols, vals = [], [], []
    for dk in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                ii, jj, kk = i + di, j + dj, k + dk
                ok = ((ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny)
                      & (kk >= 0) & (kk < nz))
                rows.append(r[ok])
                cols.append((ii + nx * (jj + ny * kk))[ok])
                vals.append(np.full(int(ok.sum()),
                                    26.0 if (di, dj, dk) == (0, 0, 0) else -1.0))
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n)).astype(dtype, copy=False)


def coarsen_injection(nx: int, ny: int, nz: int) -> np.ndarray:
    """HPCG's geometric coarsening map: fine grid ids of the coarse points.

    Coarse point (ic, jc, kc) on the (nx//2, ny//2, nz//2) grid is fine point
    (2ic, 2jc, 2kc); the returned ``f2c`` array (len = coarse n) lists those
    fine ids, so restriction is ``rc = r[f2c]`` (injection) and prolongation
    scatters back to the same points. Grid dims must be even.
    """
    assert nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0, (nx, ny, nz)
    cx, cy, cz = nx // 2, ny // 2, nz // 2
    kc, jc, ic = np.meshgrid(np.arange(cz), np.arange(cy), np.arange(cx),
                             indexing="ij")  # ic fastest => coarse-id order
    fine = 2 * ic.ravel() + nx * (2 * jc.ravel() + ny * 2 * kc.ravel())
    return fine.astype(np.int64)


def random_uniform(n: int, density: float = 0.01, seed: int = 0,
                   dtype=np.float64) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, density=density, random_state=rng, format="csr")
    m.data = rng.standard_normal(len(m.data))
    return m.astype(dtype, copy=False)


def powerlaw(n: int, avg_nnz: int = 8, alpha: float = 1.8, seed: int = 0,
             dtype=np.float64) -> sp.csr_matrix:
    """Power-law row lengths (graph-like; hostile to ELL, fine for CSR/COO)."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=n).astype(np.float64)
    lens = np.minimum((raw / raw.mean() * avg_nnz).astype(int) + 1, n)
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, size=lens.sum())
    vals = rng.standard_normal(lens.sum())
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    return m.astype(dtype, copy=False)


def block_random(n: int, bs: int = 32, block_density: float = 0.05,
                 seed: int = 0, dtype=np.float64) -> sp.csr_matrix:
    """Block-sparse (BSR country — MoE-dispatch-shaped).

    The reference's matrix from the same seed, built without its per-entry
    Python loop: the block mask first, then every block's values in one
    draw, in ``np.nonzero`` order (the order the reference draws them in),
    and the entries in the reference's (block, row, column) order, edge
    blocks clipped to the matrix.
    """
    rng = np.random.default_rng(seed)
    nb = -(-n // bs)
    mask = rng.random((nb, nb)) < block_density
    mask[np.arange(nb), np.arange(nb)] = True
    br, bc = np.nonzero(mask)
    blocks = rng.standard_normal((br.shape[0], bs, bs))
    ar = np.arange(bs)
    rows = np.broadcast_to(br[:, None, None] * bs + ar[None, :, None], blocks.shape)
    cols = np.broadcast_to(bc[:, None, None] * bs + ar[None, None, :], blocks.shape)
    inside = (rows < n) & (cols < n)
    return sp.csr_matrix((blocks[inside], (rows[inside], cols[inside])),
                         shape=(n, n)).astype(dtype, copy=False)


def diag_plus_noise(n: int, noise_nnz: int = 64, seed: int = 0,
                    dtype=np.float64) -> sp.csr_matrix:
    """Mostly-diagonal with a few scattered entries (DIA wins, barely)."""
    rng = np.random.default_rng(seed)
    m = sp.diags([rng.standard_normal(n)], [0], shape=(n, n)).tolil()
    for _ in range(noise_nnz):
        m[rng.integers(n), rng.integers(n)] = rng.standard_normal()
    return m.tocsr().astype(dtype, copy=False)


def perturb_fdm27(overlay, step: int, nx: int, ny: int, nz: int,
                  amp: float = 0.5, frac: float = 0.02, couple: int = 8,
                  seed: int = 0) -> int:
    """One time step of a moving-coefficient FDM assembly, applied through a
    :class:`~repro_torch.core.dynamic.DeltaOverlay` over an :func:`fdm27` matrix.

    Two kinds of mutation per step, mirroring how time-dependent assembly
    actually drifts:

      - **coefficient jitter** (value-only, no structural drift): a seeded
        ``frac`` of the diagonal gets ``amp``-scaled bumps — the part a
        format decision must *not* react to.
      - **widening couplings** (structural drift): ``couple`` long-range
        connections at an offset past the stencil's band extent
        (``nx*ny + nx + 1``), widening with ``step`` (plus the transpose
        mirror) — each step adds diagonals *outside* the 27-point band, so
        ``ndiags`` / ``band_extent`` drift grows monotonically with ``step``
        and eventually crosses the refresh threshold.

    Returns the number of mutations applied. Deterministic in
    ``(step, seed)``.
    """
    n = nx * ny * nz
    rng = np.random.default_rng(seed + 7919 * step)
    k = max(1, int(frac * n))
    diag = rng.choice(n, size=k, replace=False)
    for r in diag.tolist():
        overlay.add(int(r), int(r), amp * float(rng.standard_normal()))
    band = nx * ny + nx + 1                    # the 27-point stencil's extent
    off = min(n - 1, band + 1 + step * max(1, nx // 2))
    rows = rng.choice(max(1, n - off), size=min(couple, max(1, n - off)),
                      replace=False)
    applied = k
    for r in rows.tolist():
        r = int(r)
        overlay.set(r, r + off, -amp)
        overlay.set(r + off, r, -amp)
        applied += 2
    return applied


#: The suite's generator order — an explicit, documented contract (not an
#: accident of source layout): ``suite()`` iterates these per (size, seed)
#: cell, in this exact sequence, then the fdm27 grids. Corpus/selector
#: accuracy numbers are fractions over suite cells, so the iteration order
#: must be reproducible across Python versions and refactors;
#: ``tests/test_formats.py`` pins it.
SUITE_GENERATORS: Tuple[Tuple[str, object], ...] = (
    ("banded_b3", lambda s, r, dt=np.float64: banded(s, 3, seed=r, dtype=dt)),
    ("banded_b9", lambda s, r, dt=np.float64: banded(s, 9, seed=r, dtype=dt)),
    ("tridiag", lambda s, r, dt=np.float64: tridiag(s, seed=r, dtype=dt)),
    ("random_d01",
     lambda s, r, dt=np.float64: random_uniform(s, 0.01, seed=r, dtype=dt)),
    ("random_d05",
     lambda s, r, dt=np.float64: random_uniform(s, 0.05, seed=r, dtype=dt)),
    ("powerlaw", lambda s, r, dt=np.float64: powerlaw(s, seed=r, dtype=dt)),
    ("block32",
     lambda s, r, dt=np.float64: block_random(s, 32, seed=r, dtype=dt)),
    ("diagnoise",
     lambda s, r, dt=np.float64: diag_plus_noise(s, seed=r, dtype=dt)),
)

#: scale -> (sizes, grids, reps): the other axis of the iteration contract.
SUITE_SCALES: Dict[str, Tuple[list, list, int]] = {
    "small": ([64, 200], [(4, 4, 4)], 1),
    "bench": ([512, 2048, 8192], [(16, 16, 16), (24, 24, 24)], 3),
}


def suite_names(scale: str = "small") -> list:
    """The labels ``suite(scale)`` will yield, in guaranteed order —
    size-major, then seed, then ``SUITE_GENERATORS`` order, then grids."""
    sizes, grids, reps = SUITE_SCALES["small" if scale == "small" else "bench"]
    names = [f"{key}_n{s}_s{r}"
             for s in sizes for r in range(reps) for key, _ in SUITE_GENERATORS]
    names += [f"fdm27_{g[0]}x{g[1]}x{g[2]}" for g in grids]
    return names


def suite(scale: str = "small",
          dtype=np.float64) -> Iterator[Tuple[str, sp.csr_matrix]]:
    """Labeled matrix collection. ``small`` for tests, ``bench`` for figures.

    Iteration order is deterministic and part of the API: exactly
    ``suite_names(scale)``, independent of Python version or dict hashing
    (generators live in the explicit ``SUITE_GENERATORS`` tuple). ``dtype``
    is handed to every generator — the precision lane builds its narrow-
    storage corpora from the same seeds, so structure (and therefore format
    choice) is identical across value dtypes.
    """
    sizes, grids, reps = SUITE_SCALES["small" if scale == "small" else "bench"]
    for s in sizes:
        for r in range(reps):
            for key, gen in SUITE_GENERATORS:
                yield f"{key}_n{s}_s{r}", gen(s, r, dtype)
    for g in grids:
        yield f"fdm27_{g[0]}x{g[1]}x{g[2]}", fdm27(*g, dtype=dtype)


def suite_dict(scale: str = "small", dtype=np.float64) -> Dict[str, sp.csr_matrix]:
    return dict(suite(scale, dtype=dtype))
