"""The port's kernels: each plain PyTorch version against the JAX kernel on
the same numpy inputs (here, on the CPU), and each CUDA kernel against its
plain version on the card (``-m cuda``; skipped without one).

The JAX side runs as the reference's own tests run it on a CPU:
``scs_spmv``, ``dia_spmv_tiled``, ``ell_spmv``, ``ell_spmv_tiled``,
``coo_spmv``, ``scoo_spmv``, ``scoo_spmv_tiled`` and ``bsr_spmm`` in
Pallas interpret mode. The resident
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
from repro_torch.kernels._launch import segment_starts
from repro_torch.kernels.bsr_spmm import BLOCK_SIZES, bsr_spmm, bsr_spmm_plain
from repro_torch.kernels.coo_spmv import (build_scoo, coo_spmv, coo_spmv_plain, scoo_spmv,
                                          scoo_spmv_plain, scoo_spmv_tiled,
                                          scoo_spmv_tiled_plain)
from repro_torch.kernels.dia_spmv import (dia_spmv, dia_spmv_plain, dia_spmv_tiled,
                                          dia_spmv_tiled_plain)
from repro_torch.kernels.ell_spmv import (CHUNK_ROWS, _slab_sum, ell_spmv, ell_spmv_plain,
                                          ell_spmv_tiled, ell_spmv_tiled_plain, ell_tile_index)
from repro_torch.kernels.sell_spmv import (CHUNK_BLOCKS, scs_real_jsteps, scs_spmv,
                                          scs_spmv_from_plan, scs_spmv_plain, scs_work_list)

tconv = importlib.import_module("repro_torch.core.convert")
ttiling = importlib.import_module("repro_torch.core.tiling")

SHAPES = [(32, 32), (100, 100), (257, 129), (129, 300)]
DTYPES = ["float32", "bfloat16", "float16"]


def _mat(n, m, seed, kind="mixed", density=0.05):
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
    mat = sp.random(n, m, density=density, random_state=rng, format="csr")
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
            "ell": importlib.import_module("repro.kernels.ell_spmv"),
            "coo": importlib.import_module("repro.kernels.coo_spmv"),
            "bsr": importlib.import_module("repro.kernels.bsr_spmm"),
            "tiling": importlib.import_module("repro.core.tiling"),
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


def _scs_case(case):
    """Small plans of the shapes the SCS kernel meets: a 27-point stencil
    over column tiles (HPCG's), a power law whose longest rows span many
    blocks, a block matrix whose windows hold many full blocks, and one row
    far longer than the rest."""
    import scipy.sparse as sp

    from repro_torch.core import matrices as M

    if case == "stencil_tiled":
        return M.fdm27(8, 8, 8), 64
    if case == "powerlaw":
        return M.powerlaw(4000, 8), None
    if case == "block":
        return M.block_random(1024, 32, block_density=16 / 256, seed=0), None
    s = _mat(200, 2000, 4, density=0.01).tolil()
    s[17, :] = np.random.default_rng(5).standard_normal(2000)
    return s.tocsr(), None


def _scs_plan(case, dtype="float32", index_dtype="auto"):
    s, col_tile = _scs_case(case)
    T = tconv.from_dense(s, "csr", dtype=dtype, col_tile=col_tile, index_dtype=index_dtype,
                         device="cpu")
    return s, T.plan


SCS_CASES = ["stencil_tiled", "powerlaw", "block", "long_row"]


@pytest.mark.parametrize("case", SCS_CASES)
@pytest.mark.parametrize("chunk_blocks", [1, 4, 8, 32])
def test_scs_work_list_covers_every_block_once_in_order(case, chunk_blocks):
    """Chunks tile the blocks in order, each inside one window and at most
    ``chunk_blocks`` long; every window has at least one chunk; the split
    windows are those of more than one; and summing each chunk's blocks
    over their real j-steps, then each window's chunks in order, gives
    ``scs_spmv_plain``'s y."""
    s, plan = _scs_plan(case)
    btile, bwin, lsl, idx2, dat2, perm = plan.arrays
    ct, ntiles, C, sw, jb, nwin = plan.meta
    nb = btile.shape[0]
    work = scs_work_list(segment_starts(bwin, nwin), chunk_blocks)
    cb, cw, wc = (t.long().numpy() for t in work[:3])
    assert (work.nblocks, work.nwin, work.chunk_blocks) == (nb, nwin, chunk_blocks)
    assert cb[0] == 0 and cb[-1] == nb and (np.diff(cb) >= 0).all()
    assert np.diff(cb).max() <= chunk_blocks and len(cw) == len(cb) - 1
    bw = bwin.numpy()
    for c in range(len(cw)):
        assert (bw[cb[c]:cb[c + 1]] == cw[c]).all()
    assert (np.diff(cw) >= 0).all() and wc[0] == 0 and wc[-1] == len(cw)
    per_win = np.diff(wc)
    assert (per_win >= 1).all() and (np.bincount(cw, minlength=nwin) == per_win).all()
    assert work.split_win.long().tolist() == np.nonzero(per_win > 1)[0].tolist()
    longest = int(np.diff(segment_starts(bwin, nwin).numpy()).max())
    assert (len(work.split_win) > 0) == (longest > chunk_blocks)
    if case != "stencil_tiled" and chunk_blocks <= 4:
        assert len(work.split_win) > 0  # some window spans several chunks

    # the kernel's sums, in numpy: chunk partials over real prefixes, then
    # each window's partials in chunk order
    x = _x(s.shape[1]).astype(np.float64)
    nreal = scs_real_jsteps(idx2, jb).numpy()
    ids = idx2.long().numpy().reshape(nb, jb, C)
    vals = dat2.double().numpy().reshape(nb, jb, C)
    sl = lsl.numpy().reshape(nb, jb)
    bt = btile.numpy()
    ywin = np.zeros((nwin, sw, C))
    for c in range(len(cw)):
        part = np.zeros((sw, C))
        for b in range(cb[c], cb[c + 1]):
            r = nreal[b]
            cols = bt[b] * ct + np.maximum(ids[b, :r], 0)
            prod = np.where(ids[b, :r] >= 0, vals[b, :r] * x[np.minimum(cols, len(x) - 1)], 0)
            np.add.at(part, sl[b, :r], prod)
        ywin[cw[c]] += part
    yp = ywin.reshape(-1)[: perm.shape[0]]
    y = np.zeros(s.shape[0] + 1)
    y[np.minimum(perm.numpy(), s.shape[0])] = yp
    want = scs_spmv_plain(*plan.arrays, torch.from_numpy(x.astype(np.float32)),
                          nrows=s.shape[0], col_tile=ct, ntiles=ntiles, C=C, sw=sw, jb=jb,
                          nwin=nwin)
    _close(y[: s.shape[0]], want.numpy())
    _close(y[: s.shape[0]], s @ x)


@pytest.mark.parametrize("case", SCS_CASES)
def test_scs_real_jsteps_are_a_prefix_of_each_block(case):
    """Each block's real j-steps (one id >= 0) are a prefix whose suffix is
    all -1, and their count equals a count in numpy from the plan."""
    _, plan = _scs_plan(case)
    btile, _, _, idx2, _, _ = plan.arrays
    jb, C = plan.meta[4], plan.meta[2]
    nreal = scs_real_jsteps(idx2, jb)
    assert nreal.dtype == torch.int32 and nreal.shape == btile.shape
    ids = idx2.numpy().reshape(-1, jb, C)
    real = (ids >= 0).any(axis=2)
    want = real.sum(axis=1)
    assert (nreal.numpy() == want).all()
    prefix = np.arange(jb)[None, :] < want[:, None]
    assert (real == prefix).all()
    assert (ids[~prefix] == -1).all()
    if case != "block":  # a block matrix's rows fill whole blocks
        assert int(nreal.sum()) < ids.shape[0] * jb  # padding exists, and is skipped


def test_scs_plain_matches_pallas_interpret_on_a_long_row(jax_ref):
    """One row of 2,000 entries among rows of about 20: its window spans 63
    blocks, many chunks at any chunk size the kernel takes."""
    s, _ = _scs_case("long_row")
    n, m = s.shape
    x = _x(m)
    jnp = jax_ref["jnp"]
    J = jax_ref["convert"].from_dense(s, "csr")
    want = jax_ref["sell"].scs_spmv_from_plan(J.plan, jnp.asarray(x), nrows=n, interpret=True)
    _, plan = _scs_plan("long_row")
    bwin, nwin = plan.arrays[1], plan.meta[5]
    runs = segment_starts(bwin, nwin)
    assert int((runs[1:] - runs[:-1]).max()) > 32
    got = scs_spmv_from_plan(plan, torch.from_numpy(x), nrows=n)
    _close(got.numpy(), np.asarray(want, np.float32))
    _close(got.numpy(), s @ x)


#: (C, sw, jb) plans beside the default (8, 4, 32): windows of 64, 128 and
#: 256 rows, and j-step blocks the kernel cannot stage (jb % 16 != 0).
SCS_PLAN_SHAPES = [(16, 4, 32), (16, 8, 32), (32, 8, 32), (8, 4, 8), (4, 8, 24)]


def _scs_plans_of_shape(s, C, sw, jb, index_dtype="auto", device="cpu"):
    """The port's plan of ``s`` at (C, sw, jb) on ``device``, and the
    reference's numpy plan."""
    kw = dict(C=C, slice_window=sw, jstep_block=jb, index_dtype=index_dtype)
    plan = ttiling.build_scs_plan(s, **kw)
    return ttiling.plan_to_tensors(plan, torch.float32, device), plan


@pytest.mark.parametrize("C,sw,jb", SCS_PLAN_SHAPES)
def test_scs_plain_matches_pallas_interpret_at_other_plan_shapes(jax_ref, C, sw, jb):
    """Plans of other slice widths, windows and j-step blocks: the port's
    arrays equal the reference's, and on the CPU the wrapper's plain
    version matches the Pallas kernel in interpret mode (the card's kernel
    takes jb a multiple of 16 only; the CPU takes any)."""
    s, _ = _scs_case("long_row")
    n, m = s.shape
    x = _x(m)
    T, host = _scs_plans_of_shape(s, C, sw, jb)
    ref = importlib.import_module("repro.core.tiling").build_scs_plan(
        s, C=C, slice_window=sw, jstep_block=jb)
    assert tuple(host.meta) == tuple(ref.meta)
    for a, b in zip(host.arrays, ref.arrays):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jnp = jax_ref["jnp"]
    want = jax_ref["sell"].scs_spmv_from_plan(
        type(ref)(ref.kind, tuple(jnp.asarray(a) for a in ref.arrays), ref.meta),
        jnp.asarray(x), nrows=n, interpret=True)
    got = scs_spmv_from_plan(T, torch.from_numpy(x), nrows=n)
    _close(got.numpy(), np.asarray(want, np.float32))
    _close(got.numpy(), s @ x)


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


def _assert_same_plan(t_arrays, j_arrays):
    """The two packages built the same plan: equal arrays, equal dtypes
    (values compared in f32, where bf16 is exact)."""
    for a, b in zip(t_arrays, j_arrays):
        b = np.asarray(b)
        if b.dtype.kind in "iu":
            assert str(a.dtype) == f"torch.{b.dtype.name}"
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32))


# ------------------------------------------------- ell_spmv, ell_spmv_tiled ----


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("col_tile,index_dtype",
                         [(None, "int32"), (64, "int8"), (64, "int16"), (64, "int32")])
def test_ell_plain_matches_pallas_interpret(jax_ref, shape, dtype, col_tile, index_dtype):
    """``ell_spmv_plain`` (no column tile) and ``ell_spmv_tiled_plain`` (an
    ``"ell-cols"`` plan of 64-column tiles) against the Pallas kernels in
    interpret mode, on containers and plans each package built from the
    same scipy matrix."""
    n, m = shape
    s = _mat(n, m, 12)
    x = _x(m)
    jnp = jax_ref["jnp"]
    J = jax_ref["convert"].from_dense(s, "ell", dtype=_jax_dtype(jnp, dtype),
                                      col_tile=col_tile, index_dtype=index_dtype)
    T = tconv.from_dense(s, "ell", dtype=dtype, col_tile=col_tile,
                         index_dtype=index_dtype, device="cpu")
    if col_tile is None:
        want = jax_ref["ell"].ell_spmv(J.indices, J.data, jnp.asarray(x), interpret=True)
        got = ell_spmv(T.indices, T.data, torch.from_numpy(x))
    else:
        _assert_same_plan(T.plan.arrays, J.plan.arrays)
        want = jax_ref["ell"].ell_spmv_tiled(*J.plan.arrays, jnp.asarray(x),
                                             col_tile=col_tile, interpret=True)
        got = ell_spmv_tiled(*T.plan.arrays, torch.from_numpy(x), col_tile=col_tile)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), _tol(dtype, s))


@pytest.mark.parametrize("col_tile", [None, 16])
def test_masked_ell_is_where_of_unmasked(col_tile):
    """The masked ELL wrapper (mask inside the kernel) equals
    ``where(mask, A @ x, 0)`` exactly, resident and tiled."""
    from repro_torch.core import ExecutionPolicy

    s = _mat(257, 257, 13)
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False,
                          max_resident_cols=1 << 20 if col_tile is None else 32)
    E = tconv.from_dense(s, "ell", col_tile=col_tile, device="cpu")
    assert ops.cuda_strategy(E, pol) == ("resident" if col_tile is None else "tiled")
    x = torch.from_numpy(_x(257))
    mask = torch.from_numpy(np.random.default_rng(6).random(257) < 0.4)
    got = ops.ell_masked_spmv_cuda(E, x, mask, pol)
    want = torch.where(mask, ops.ell_spmv_cuda(E, x, pol), torch.zeros(()))
    assert torch.equal(got, want)


def test_ell_tiled_plain_sums_the_resident_products():
    """The tiled plain version over one tile is the resident one, bit for
    bit (the same slots in the same order)."""
    s = _mat(100, 100, 14)
    x = torch.from_numpy(_x(100))
    E = tconv.from_dense(s, "ell", col_tile=128, device="cpu")
    assert E.plan.ntiles == 1
    assert torch.equal(ell_spmv_tiled(*E.plan.arrays, x, col_tile=128),
                       ell_spmv(E.indices, E.data, x))


def _ell_index_matrix(col_tile):
    """300 rows (three chunks, the last one ragged) over five and a bit
    column tiles: chunk 0 has
    entries only in column tiles 0 and 3 (not adjacent), with 40 in one
    tile on row 2 where the tile is wider than 32 (W > 32); chunk 1 has
    none; chunk 2 is random over every tile."""
    import scipy.sparse as sp

    n, m = 300, 5 * col_tile + 3
    rng = np.random.default_rng(31)
    dense = np.zeros((n, m))
    for lo in (0, 3 * col_tile):
        shape = (CHUNK_ROWS, col_tile)
        dense[:CHUNK_ROWS, lo:lo + col_tile] = (
            (rng.random(shape) < 0.1) * rng.standard_normal(shape))
    if col_tile > 32:
        dense[2, :40] = rng.standard_normal(40)
    dense[2 * CHUNK_ROWS:] = (rng.random((n - 2 * CHUNK_ROWS, m)) < 0.05) * rng.standard_normal(
        (n - 2 * CHUNK_ROWS, m))
    return sp.csr_matrix(dense)


def _listed_by_brute_force(idx_t: np.ndarray):
    ntiles, nrows, _ = idx_t.shape
    ptr, ids = [0], []
    for c in range(-(-nrows // CHUNK_ROWS)):
        chunk = idx_t[:, c * CHUNK_ROWS:(c + 1) * CHUNK_ROWS]
        ids += [t for t in range(ntiles) if (chunk[t] >= 0).any()]
        ptr.append(len(ids))
    return np.array(ptr), np.array(ids)


ELL_INDEX_CASES = [(16, "int8"), (16, "int32"), (64, "int8"), (64, "int16"), (128, "int16"),
                   (128, "int32")]


@pytest.mark.parametrize("col_tile,index_dtype", ELL_INDEX_CASES)
def test_ell_tile_index_lists_each_chunks_tiles(jax_ref, col_tile, index_dtype):
    """The tile index of an ``"ell-cols"`` plan that the reference builds
    equals a brute-force listing: an empty chunk lists nothing, a chunk
    lists tiles that are not adjacent, the ragged last chunk counts only
    its rows; and it does not rely on a row's entries being packed left."""
    s = _ell_index_matrix(col_tile)
    plan = jax_ref["tiling"].build_ell_col_plan(s, col_tile, index_dtype=index_dtype)
    idx_t = np.asarray(plan.arrays[0])
    assert idx_t.dtype == np.dtype(index_dtype)
    assert idx_t.shape[1] % CHUNK_ROWS and (col_tile <= 32 or idx_t.shape[2] > 32)
    tile_ptr, tile_ids, _ = ell_tile_index(torch.from_numpy(idx_t))
    assert tile_ptr.dtype == tile_ids.dtype == torch.int32
    want_ptr, want_ids = _listed_by_brute_force(idx_t)
    np.testing.assert_array_equal(tile_ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(tile_ids.numpy(), want_ids)
    assert tile_ids[tile_ptr[0]:tile_ptr[1]].tolist() == [0, 3]  # chunk 0
    assert tile_ptr[1] == tile_ptr[2]                             # chunk 1 is empty
    flipped = ell_tile_index(torch.from_numpy(np.ascontiguousarray(idx_t[..., ::-1])))
    assert all(torch.equal(a, b) for a, b in zip(flipped, (tile_ptr, tile_ids)))


@pytest.mark.parametrize("col_tile,index_dtype", ELL_INDEX_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_ell_sum_over_listed_tiles_equals_tiled_plain(jax_ref, col_tile, index_dtype, masked):
    """Adding only the tiles the index lists for a row's chunk, in
    ascending order, gives ``ell_spmv_tiled_plain`` (which adds every
    tile's sum) bit for bit in f32: a skipped tile adds +0 to a total that
    is never -0."""
    s = _ell_index_matrix(col_tile)
    plan = jax_ref["tiling"].build_ell_col_plan(s, col_tile, index_dtype=index_dtype)
    idx_t = torch.from_numpy(np.asarray(plan.arrays[0]))
    dat_t = torch.from_numpy(np.asarray(plan.arrays[1], np.float32))
    x = torch.from_numpy(_x(s.shape[1]))
    mask = torch.from_numpy(np.random.default_rng(6).random(s.shape[0]) < 0.5) if masked else None
    tile_ptr, tile_ids, _ = ell_tile_index(idx_t)
    chunk_of_row = torch.arange(s.shape[0]) // CHUNK_ROWS
    y = torch.zeros(s.shape[0])
    for t in range(idx_t.shape[0]):
        listed = torch.zeros(len(tile_ptr) - 1, dtype=torch.bool)
        for c in range(len(tile_ptr) - 1):
            listed[c] = bool((tile_ids[tile_ptr[c]:tile_ptr[c + 1]] == t).any())
        part = _slab_sum(idx_t[t], dat_t[t], x[t * col_tile:], mask)
        y = torch.where(listed[chunk_of_row], y + part, y)
    assert torch.equal(y, ell_spmv_tiled_plain(idx_t, dat_t, x, col_tile, mask))
    assert int(tile_ptr[-1]) < idx_t.shape[0] * len(tile_ptr[1:])  # tiles were skipped


@pytest.mark.parametrize("wrong", ["other_plan", "copy_of_plan", "bare_pair"])
def test_ell_spmv_tiled_refuses_an_index_of_another_plan(wrong):
    """The tiled ELL kernel reads the plan at the offsets its index lists,
    so ``ell_spmv_tiled`` takes only ``ell_tile_index`` of the very
    ``idx_t`` it is given (on the CPU too, where the plain version runs):
    an index of another plan, of a copy of this one, or a bare
    ``(tile_ptr, tile_ids)`` pair raises ``ValueError``; its own index
    gives the plain result."""
    s = _ell_index_matrix(16)
    E = tconv.from_dense(s, "ell", col_tile=16, device="cpu")
    idx_t, dat_t = E.plan.arrays
    x = torch.from_numpy(_x(s.shape[1]))
    own = ell_tile_index(idx_t)
    assert torch.equal(ell_spmv_tiled(idx_t, dat_t, x, col_tile=16, tile_index=own),
                       ell_spmv_tiled_plain(idx_t, dat_t, x, 16))
    if wrong == "other_plan":
        other = tconv.from_dense(s[:200], "ell", col_tile=16, device="cpu")
        index = ell_tile_index(other.plan.arrays[0])
    elif wrong == "copy_of_plan":
        index = ell_tile_index(idx_t.clone())
    else:
        index = tuple(own[:2])
    with pytest.raises(ValueError, match="tile_index"):
        ell_spmv_tiled(idx_t, dat_t, x, col_tile=16, tile_index=index)


def _ell_resident_case(case):
    """A resident ELL matrix: ``"ragged"`` 300 rows whose chunk 1 is empty
    (its rows hold only padding); ``"stencil"`` the 27-point stencil of 9^3
    (W = 27); ``"wide"`` rows of up to 64 slots."""
    import scipy.sparse as sp

    rng = np.random.default_rng(35)
    if case == "ragged":
        dense = (rng.random((300, 150)) < 0.05) * rng.standard_normal((300, 150))
        dense[CHUNK_ROWS:2 * CHUNK_ROWS] = 0
        return sp.csr_matrix(dense)
    if case == "stencil":
        from repro_torch.core import matrices as TM

        return TM.fdm27(9, 9, 9)
    dense = (rng.random((200, 90)) < 0.3) * rng.standard_normal((200, 90))
    dense[5, :64] = rng.standard_normal(64)
    return sp.csr_matrix(dense)


@pytest.mark.parametrize("case", ["ragged", "stencil", "wide"])
def test_ell_resident_tile_index_is_the_one_tile_listing(jax_ref, case):
    """The resident ELL kernel is the tiled one over a plan of one tile: the
    index it takes, ``ell_tile_index(indices[None])`` of the indices the
    reference's ``to_ell`` builds, lists tile 0 for exactly the chunks
    that hold an id >= 0 (a brute-force listing), and the tiled plain
    version over that one-tile plan is the resident plain version bit for
    bit, masked too."""
    s = _ell_resident_case(case)
    J = jax_ref["convert"].from_dense(s, "ell")
    idx = np.asarray(J.indices)
    E = tconv.from_dense(s, "ell", device="cpu")
    np.testing.assert_array_equal(E.indices.numpy(), idx)
    listed = ell_tile_index(E.indices.unsqueeze(0))
    tile_ptr, tile_ids, source = listed
    want_ptr, want_ids = _listed_by_brute_force(idx[None])
    np.testing.assert_array_equal(tile_ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(tile_ids.numpy(), want_ids)
    assert set(tile_ids.tolist()) <= {0}
    assert source == (E.indices.data_ptr(), E.indices.device, 1, s.shape[0])
    x = torch.from_numpy(_x(s.shape[1]))
    mask = torch.from_numpy(np.random.default_rng(36).random(s.shape[0]) < 0.5)
    for m in (None, mask):
        assert torch.equal(
            ell_spmv_tiled_plain(E.indices[None], E.data[None], x, s.shape[1], m),
            ell_spmv(E.indices, E.data, x, mask=m, tile_index=listed))


@pytest.mark.parametrize("wrong", ["other_indices", "copy_of_indices", "tiled_plan", "bare_pair"])
def test_ell_spmv_refuses_an_index_of_other_indices(wrong):
    """``ell_spmv`` takes only the one-tile index of its very ``indices``
    (on the CPU too): an index of other indices, of a copy, of a tiled
    plan, or a bare pair raises ``ValueError``; its own gives the plain
    result."""
    s = _ell_resident_case("ragged")
    E = tconv.from_dense(s, "ell", col_tile=64, device="cpu")
    x = torch.from_numpy(_x(s.shape[1]))
    own = ell_tile_index(E.indices.unsqueeze(0))
    assert torch.equal(ell_spmv(E.indices, E.data, x, tile_index=own),
                       ell_spmv_plain(E.indices, E.data, x))
    if wrong == "other_indices":
        index = ell_tile_index(tconv.from_dense(s[:200], "ell", device="cpu").indices[None])
    elif wrong == "copy_of_indices":
        index = ell_tile_index(E.indices.clone().unsqueeze(0))
    elif wrong == "tiled_plan":
        index = ell_tile_index(E.plan.arrays[0])
    else:
        index = tuple(own[:2])
    with pytest.raises(ValueError, match="tile_index"):
        ell_spmv(E.indices, E.data, x, tile_index=index)


def _row_mask(kind, n=729, seed=40):
    if kind == "random":
        return torch.from_numpy(np.random.default_rng(seed).random(n) < 0.4)
    if kind == "symgs":
        from repro_torch.core import matrices as TM
        from repro_torch.solvers.symgs import greedy_coloring

        return torch.from_numpy(greedy_coloring(TM.fdm27(9, 9, 9)) == 5)
    return torch.full((n,), kind == "all", dtype=torch.bool)


@pytest.mark.parametrize("kind", ["random", "symgs", "none", "all"])
def test_dia_row_list_is_the_masks_rows(kind):
    """``dia_row_list`` lists the rows a mask keeps, ascending, as int32
    (its plain definition: ``np.nonzero``), and records the mask."""
    from repro_torch.kernels.dia_spmv import dia_row_list

    mask = _row_mask(kind)
    rows = dia_row_list(mask)
    assert rows.rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.rows.numpy(), np.nonzero(mask.numpy())[0])
    assert rows.source == (mask.data_ptr(), mask.device, mask.numel())
    assert rows.mask is mask and rows.version == mask._version


@pytest.mark.parametrize("wrong", ["other_mask", "written_since", "no_mask", "bare_tensor"])
def test_dia_spmv_refuses_a_stale_row_list(wrong):
    """``dia_spmv`` takes only the row list of its very mask, built since
    the mask's last in-place write (on the CPU too): anything else raises
    ``ValueError``; its own list gives the plain result."""
    from repro_torch.kernels.dia_spmv import dia_row_list

    s = _mat(729, 729, 41, "banded")
    D = tconv.from_dense(s, "dia", device="cpu")
    x = torch.from_numpy(_x(729))
    mask = _row_mask("symgs").clone()
    own = dia_row_list(mask)
    assert torch.equal(dia_spmv(D.offsets, D.data, x, mask, rows=own),
                       dia_spmv_plain(D.offsets, D.data, x, mask))
    if wrong == "other_mask":
        rows, m = dia_row_list(mask.clone()), mask
    elif wrong == "written_since":
        mask[3] = ~mask[3]
        rows, m = own, mask
    elif wrong == "no_mask":
        rows, m = own, None
    else:
        rows, m = own.rows, mask
    with pytest.raises(ValueError, match="rows"):
        dia_spmv(D.offsets, D.data, x, m, rows=rows)


def test_dia_cached_row_lists_follow_their_masks():
    """The adapter's cache holds one list per mask: the same mask finds its
    list again, an in-place write to the mask rebuilds it, and past
    ``MAX_ROW_LISTS`` masks the oldest list is dropped."""
    from repro_torch.kernels.dia_spmv import MAX_ROW_LISTS, _cached_rows

    cache = {}
    masks = [_row_mask("random", seed=k) for k in range(MAX_ROW_LISTS + 1)]
    first = _cached_rows(cache, masks[0])
    assert _cached_rows(cache, masks[0]) is first
    masks[0][: 10] = True
    rebuilt = _cached_rows(cache, masks[0])
    assert rebuilt is not first
    np.testing.assert_array_equal(rebuilt.rows.numpy(), np.nonzero(masks[0].numpy())[0])
    for m in masks[1:]:
        _cached_rows(cache, m)
    assert len(cache["rows"]) == MAX_ROW_LISTS
    assert (masks[0].data_ptr(), masks[0].device, masks[0].numel()) not in cache["rows"]


def test_dia_adapter_runs_plain_on_the_host_and_caches_nothing():
    """On host tensors the DIA adapter is the plain version (masked too)
    and leaves the container's cache empty: only a launch on the card
    keeps its checked arrays there."""
    from repro_torch.kernels.dia_spmv import dia_spmv_from_container

    s = _mat(300, 280, 37, "banded")
    D = tconv.from_dense(s, "dia", device="cpu")
    x = torch.from_numpy(_x(280))
    mask = torch.from_numpy(np.random.default_rng(38).random(300) < 0.5)
    assert torch.equal(dia_spmv_from_container(D, x), dia_spmv_plain(D.offsets, D.data, x))
    assert torch.equal(dia_spmv_from_container(D, x, mask),
                       dia_spmv_plain(D.offsets, D.data, x, mask))
    assert D.cache == {} and "cache" not in repr(D)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_tiled_adapter_matches_pallas_interpret(jax_ref, masked, dtype):
    """dia/cuda under a ``max_resident_cols`` small enough to tile (rows
    reach one to three column tiles) runs ``dia_spmv_tiled_from_plan``; on
    the host it equals the reference's tiled Pallas kernel in interpret
    mode (masked: ``where(mask, ., 0)`` of it) and ``to_dense() @ x``,
    within the stated tolerance, and its masked call is ``where(mask, A @
    x, 0)`` exactly."""
    from repro_torch.core import ExecutionPolicy

    n = m = 300
    s = _mat(n, m, 42, "banded")
    x = _x(m)
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False, max_resident_cols=16)
    ct = pol.col_tile(m)
    D = tconv.from_dense(s, "dia", dtype=dtype, col_tile=ct, device="cpu")
    assert ops.cuda_strategy(D, pol) == "tiled" and D.plan.ct == ct
    jnp = jax_ref["jnp"]
    J = jax_ref["convert"].from_dense(s, "dia", dtype=_jax_dtype(jnp, dtype), col_tile=ct)
    _assert_same_plan(D.plan.arrays, J.plan.arrays)
    want = np.asarray(jax_ref["dia"].dia_spmv_tiled(*J.plan.arrays, jnp.asarray(x), nrows=n,
                                                    col_tile=ct, interpret=True), np.float32)
    dense = D.to_dense().float().numpy() @ x
    xt = torch.from_numpy(x)
    mask = torch.from_numpy(np.random.default_rng(43).random(n) < 0.4) if masked else None
    if masked:
        got = ops.dia_masked_spmv_cuda(D, xt, mask, pol)
        assert torch.equal(got, torch.where(mask, ops.dia_spmv_cuda(D, xt, pol),
                                            torch.zeros((), dtype=got.dtype)))
        want, dense = np.where(mask.numpy(), want, 0), np.where(mask.numpy(), dense, 0)
    else:
        got = ops.dia_spmv_cuda(D, xt, pol)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want, _tol(dtype, s))
    _close(got.float().numpy(), dense, _tol(dtype, s))
    assert D.plan.cache == {}  # on the host nothing is checked or kept


def test_tiled_and_coo_records_refuse_what_the_kernels_do_not_take():
    """The records the tiled DIA and full-window COO adapters keep are
    built by full checks: a plan or arrays of the wrong type or shape, or
    on the host, raise ``ValueError`` before any launch."""
    from repro_torch.kernels.coo_spmv import _rows
    from repro_torch.kernels.dia_spmv import _tiled

    D = tconv.from_dense(_mat(100, 100, 44, "banded"), "dia", col_tile=16, device="cpu")
    offs_t, dat_w = D.plan.arrays
    for bad in ((offs_t.long(), dat_w, 100, 16), (offs_t[:-1], dat_w, 100, 16),
                (offs_t, dat_w, 100, 32), (offs_t, dat_w, 100, 16)):
        with pytest.raises(ValueError):
            _tiled(*bad)
    C = tconv.from_dense(_mat(100, 100, 45), "coo", device="cpu")
    for bad in ((C.row.long(), C.col, C.val, 100), (C.row, C.col[:-1], C.val, 100),
                (C.row, C.col, C.val, 100)):
        with pytest.raises(ValueError):
            _rows(*bad)


def test_tiled_and_coo_adapters_run_plain_on_the_host_and_cache_nothing():
    """On host tensors the tiled DIA and the full-window COO adapters are
    the plain versions (masked too) and keep nothing: only a launch on the
    card keeps its checked arrays in ``plan.cache`` or ``A.cache``."""
    from repro_torch.kernels.coo_spmv import coo_spmv_from_container
    from repro_torch.kernels.dia_spmv import dia_spmv_tiled_from_plan

    s = _mat(300, 280, 46, "banded")
    D = tconv.from_dense(s, "dia", col_tile=32, device="cpu")
    x = torch.from_numpy(_x(280))
    mask = torch.from_numpy(np.random.default_rng(47).random(300) < 0.5)
    for m in (None, mask):
        assert torch.equal(dia_spmv_tiled_from_plan(D.plan, x, 300, m),
                           dia_spmv_tiled_plain(*D.plan.arrays, x, 300, 32, m))
    assert D.plan.cache == {}
    C = tconv.from_dense(_mat(300, 280, 48), "coo", pad_to=64, device="cpu")
    assert torch.equal(coo_spmv_from_container(C, x),
                       coo_spmv_plain(C.row, C.col, C.val, x, 300))
    assert C.cache == {}


# --------------------------------------------------- coo_spmv, scoo_spmv_tiled ----


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_coo_plain_matches_pallas_interpret(jax_ref, shape, dtype):
    """``coo_spmv_plain`` against the full-window Pallas kernel, with tail
    sentinels (``row == nrows``) in the arrays."""
    n, m = shape
    s = _mat(n, m, 15)
    x = _x(m)
    jnp = jax_ref["jnp"]
    J = jax_ref["convert"].from_dense(s, "coo", dtype=_jax_dtype(jnp, dtype), pad_to=64)
    T = tconv.from_dense(s, "coo", dtype=dtype, pad_to=64, device="cpu")
    _assert_same_plan((T.row, T.col, T.val), (J.row, J.col, J.val))
    want = jax_ref["coo"].coo_spmv(J.row, J.col, J.val, jnp.asarray(x), nrows=n,
                                   interpret=True)
    got = coo_spmv(T.row, T.col, T.val, torch.from_numpy(x), nrows=n)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), _tol(dtype, s))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_coo_adapter_matches_pallas_interpret(jax_ref, shape, dtype):
    """coo/cuda on a matrix the reference keeps whole runs the full window
    through ``coo_spmv_from_container``; on the host it equals the
    reference's full-window Pallas kernel in interpret mode, with tail
    sentinels in the arrays and some rows empty, within the stated
    tolerance."""
    import scipy.sparse as sp

    from repro_torch.core import ExecutionPolicy

    n, m = shape
    keep = (np.arange(n) % 5 != 2).astype(np.float64)  # every fifth row empty
    s = sp.csr_matrix(sp.diags(keep) @ _mat(n, m, 49))
    s.eliminate_zeros()
    x = _x(m)
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
    T = tconv.from_dense(s, "coo", dtype=dtype, pad_to=64, device="cpu")
    assert ops.cuda_strategy(T, pol) == "resident"
    jnp = jax_ref["jnp"]
    J = jax_ref["convert"].from_dense(s, "coo", dtype=_jax_dtype(jnp, dtype), pad_to=64)
    want = jax_ref["coo"].coo_spmv(J.row, J.col, J.val, jnp.asarray(x), nrows=n,
                                   interpret=True)
    got = ops.coo_spmv_cuda(T, torch.from_numpy(x), pol)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), _tol(dtype, s))
    assert T.cache == {}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index_dtype", ["int8", "int16", "int32"])
def test_scoo_tiled_plain_matches_pallas_interpret(jax_ref, shape, dtype, index_dtype):
    """``scoo_spmv_tiled_plain`` against the Pallas kernel on a
    ``"coo-cols"`` plan of 32-row slices, 64-entry blocks and 64-column
    tiles, built by each package's ``build_coo_col_plan`` from the same
    numpy arrays (so several slices and a partial last tile are walked)."""
    n, m = shape
    s = _mat(n, m, 16).tocoo()
    x = _x(m)
    jnp = jax_ref["jnp"]
    order = np.lexsort((s.col, s.row))
    row, col = s.row[order].astype(np.int32), s.col[order].astype(np.int32)
    val = s.data[order].astype(ttiling.staging_dtype(dtype))
    kw = dict(col_tile=64, slice_rows=32, tile=64, index_dtype=index_dtype)
    jp = jax_ref["tiling"].build_coo_col_plan(row, col, val, (n, m), **kw)
    tp = ttiling.plan_to_tensors(ttiling.build_coo_col_plan(row, col, val, (n, m), **kw),
                                 dtype, "cpu")
    jr, jc, jv, jsid, jct = jp.arrays
    jv = jnp.asarray(jv, _jax_dtype(jnp, dtype))  # the value dtype, as from_dense rounds
    _assert_same_plan(tp.arrays, (jr, jc, jv, jsid, jct))
    want = jax_ref["coo"].scoo_spmv_tiled(jr, jc, jv, jsid, jct, jnp.asarray(x), nrows=n,
                                          col_tile=64, ntiles=jp.meta[1], slice_rows=32,
                                          tile=64, interpret=True)
    got = scoo_spmv_tiled(*tp.arrays, torch.from_numpy(x), nrows=n, col_tile=64,
                          slice_rows=32, tile=64)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), _tol(dtype, s))


def _scoo_arrays(s, dtype, slice_rows, tile):
    """A row-sorted COO of ``s`` (values rounded to ``dtype`` on the host)
    and its ``build_scoo`` layout."""
    coo = s.tocoo()
    order = np.lexsort((coo.col, coo.row))
    val = coo.data[order].astype(ttiling.staging_dtype(dtype))
    return build_scoo(coo.row[order], coo.col[order], val, s.shape[0], slice_rows, tile)


@pytest.mark.parametrize("n,m,slice_rows,tile,density", [
    (257, 129, 32, 64, 0.05), (1000, 1000, 64, 32, 0.01), (100, 100, 32, 16, 0.0),
    (3000, 500, 512, 512, 0.002), (64, 64, 64, 8, 0.5)])
def test_build_scoo_equals_reference(jax_ref, n, m, slice_rows, tile, density):
    """The vectorised ``build_scoo`` gives the reference's four arrays:
    equal values, dtypes and order, empty slices (one tile of pads) and a
    ragged last slice included."""
    s = _mat(n, m, 20, density=density)
    coo = s.tocoo()
    order = np.lexsort((coo.col, coo.row))
    args = (coo.row[order], coo.col[order], coo.data[order].astype(np.float32), n,
            slice_rows, tile)
    got, want = build_scoo(*args), jax_ref["coo"].build_scoo(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_scoo_plain_matches_pallas_interpret(jax_ref, shape, dtype):
    """``scoo_spmv`` (its plain version, here) against the sliced Pallas
    kernel on the same ``build_scoo`` layout of 32-row slices and 64-entry
    blocks."""
    n, m = shape
    s = _mat(n, m, 21)
    x = _x(m)
    jnp = jax_ref["jnp"]
    row, col, val, sid = _scoo_arrays(s, dtype, 32, 64)
    jv = jnp.asarray(val, _jax_dtype(jnp, dtype))
    want = jax_ref["coo"].scoo_spmv(row, col, jv, sid, jnp.asarray(x), nrows=n,
                                    slice_rows=32, tile=64, interpret=True)
    tv = torch.from_numpy(np.asarray(val, np.float32)).to(getattr(torch, dtype))
    got = scoo_spmv(torch.from_numpy(row), torch.from_numpy(col), tv, torch.from_numpy(sid),
                    torch.from_numpy(x), nrows=n, slice_rows=32, tile=64)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), _tol(dtype, s))


def _coo_in_order(s, order):
    """The (row, col, data) triplets of ``s`` column-major (``"csc"``) or in
    a random order (``"shuffled"``): not row-sorted inside a slice."""
    if order == "csc":
        coo = s.tocsc().tocoo()
        return coo.row, coo.col, coo.data
    coo = s.tocoo()
    perm = np.random.default_rng(27).permutation(coo.nnz)
    return coo.row[perm], coo.col[perm], coo.data[perm]


@pytest.mark.parametrize("order", ["csc", "shuffled"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scoo_plain_matches_pallas_interpret_in_any_entry_order(jax_ref, order, dtype):
    """A COO that is not row-sorted gives ``build_scoo`` slices in input
    order; ``scoo_spmv`` and the reference's layout and kernel agree on it."""
    n, m = 257, 129
    s = _mat(n, m, 28)
    row, col, data = _coo_in_order(s, order)
    args = (row, col, data.astype(ttiling.staging_dtype(dtype)), n, 32, 64)
    got, want = build_scoo(*args), jax_ref["coo"].build_scoo(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    row, col, val, sid = got
    x = _x(m)
    jnp = jax_ref["jnp"]
    want = jax_ref["coo"].scoo_spmv(row, col, jnp.asarray(val, _jax_dtype(jnp, dtype)), sid,
                                    jnp.asarray(x), nrows=n, slice_rows=32, tile=64,
                                    interpret=True)
    tv = torch.from_numpy(np.asarray(val, np.float32)).to(getattr(torch, dtype))
    y = scoo_spmv(torch.from_numpy(row), torch.from_numpy(col), tv, torch.from_numpy(sid),
                  torch.from_numpy(x), nrows=n, slice_rows=32, tile=64)
    _close(y.float().numpy(), np.asarray(want, np.float32), _tol(dtype, s))


def _bsr_operands(n, m, bs, nf, dtype, seed=22):
    """A BSR container of a random (n, m) matrix at block edge ``bs``, one
    padding slot of its widest block row turned into a real-looking block
    whose column id is past the last block column, and an (m, nf) X."""
    s = _mat(n, m, seed)
    B = tconv.from_dense(s, "bsr", bs=bs, dtype=dtype, device="cpu")
    bcols, blocks = B.bcols.clone(), B.blocks.clone()
    counts = (bcols >= 0).sum(1)
    w = int(counts.max())
    bcols = torch.cat([bcols, torch.full((bcols.shape[0], 1), -1, dtype=torch.int32)], 1)
    blocks = torch.cat([blocks, torch.zeros_like(blocks[:, :1])], 1)
    r = int(counts.argmax())
    nbcols = -(-m // bs)
    bcols[r, w] = nbcols + 3
    blocks[r, w] = torch.ones((bs, bs), dtype=blocks.dtype)
    X = np.random.default_rng(seed + 1).standard_normal((m, nf)).astype(np.float32)
    return s, bcols, blocks, X


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("nf", [1, 5, 130])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bsr_plain_matches_pallas_interpret(jax_ref, bs, nf, dtype):
    """``bsr_spmm`` (its plain version, here) against the Pallas kernel on
    the same arrays: every block edge ``to_bsr`` produces, one column, a
    few, and a ragged last feature tile (130 = 128 + 2), with a block id
    past the last block column, which contributes zero."""
    s, bcols, blocks, X = _bsr_operands(257, 300, bs, nf, dtype)
    jnp = jax_ref["jnp"]
    jb = jnp.asarray(blocks.float().numpy(), _jax_dtype(jnp, dtype))
    want = np.asarray(jax_ref["bsr"].bsr_spmm(jnp.asarray(bcols.numpy()), jb, jnp.asarray(X),
                                              interpret=True), np.float32)
    got = bsr_spmm(bcols, blocks, torch.from_numpy(X))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want, _tol(dtype, s))
    _close(got[:257].numpy(), s @ X, None if dtype == "float32" else 0.05)


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("op", ["spmv", "spmm", "masked_spmv"])
def test_bsr_cuda_entries_match_pallas_entries(jax_ref, bs, op):
    """The ``bsr/cuda`` SpMV, SpMM and masked SpMV entries (plain versions,
    here) against the reference's ``bsr/pallas`` entries in interpret mode,
    strict dispatch on both sides."""
    import repro.core as J

    import repro_torch.core as T

    s = _mat(200, 150, 23)
    x = _x(150)
    X = np.stack([x, _x(150, seed=2), _x(150, seed=3)], axis=1)
    mask = np.random.default_rng(24).random(200) < 0.5
    jnp = jax_ref["jnp"]
    J_A = jax_ref["convert"].from_dense(s, "bsr", bs=bs)
    T_A = tconv.from_dense(s, "bsr", bs=bs, device="cpu")
    jp = J.ExecutionPolicy(backends=("pallas",), allow_fallback=False)
    tp = T.ExecutionPolicy(backends=("cuda",), allow_fallback=False)
    if op == "spmv":
        want = J.spmv(J_A, jnp.asarray(x), policy=jp)
        got = T.spmv(T_A, torch.from_numpy(x), policy=tp)
    elif op == "spmm":
        want = J.spmm(J_A, jnp.asarray(X), policy=jp)
        got = T.spmm(T_A, torch.from_numpy(X), policy=tp)
    else:
        want = J.masked_spmv(J_A, jnp.asarray(x), jnp.asarray(mask), policy=jp)
        got = T.masked_spmv(T_A, torch.from_numpy(x), torch.from_numpy(mask), policy=tp)
        assert (got.numpy()[~mask] == 0).all()
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), np.asarray(want, np.float32))


def test_segment_starts_bound_sorted_runs():
    keys = torch.tensor([0, 0, 2, 2, 2, 3, 5, 5], dtype=torch.int32)
    assert segment_starts(keys, 5).tolist() == [0, 2, 2, 5, 6, 6]
    assert segment_starts(keys, 5).dtype == torch.int32


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
@pytest.mark.parametrize("case", SCS_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,sw", [(8, 4), (16, 4), (16, 8), (32, 8)])
def test_scs_kernel_splits_long_windows_on_card(cuda, case, dtype, C, sw):
    """Windows cut into chunks (long rows, a block matrix's full windows)
    and windows of one chunk, at the default 32 rows a window and at 64,
    128 and 256 (a lane owning 2, 4 or 8 rows), against the plain version,
    equal bits over two launches, and int16 ids equal to int32."""
    s, col_tile = _scs_case(case)
    n = s.shape[0]
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(_x(s.shape[1])).to(cuda)
    ys = {}
    for index_dtype in ("int16", "int32"):
        plan = ttiling.plan_to_tensors(
            ttiling.build_scs_plan(s, col_tile=col_tile, C=C, slice_window=sw, dtype=tdt,
                                   index_dtype=index_dtype), tdt, cuda)
        assert plan.meta[2:4] == (C, sw)
        before = scs_spmv.launches
        y = scs_spmv_from_plan(plan, x, nrows=n)
        assert scs_spmv.launches == before + 1
        work = plan.cache["work"]
        assert work.chunk_blocks == CHUNK_BLOCKS
        runs = segment_starts(plan.arrays[1], plan.meta[5])
        longest = int((runs[1:] - runs[:-1]).max())
        assert (work.split_win.shape[0] > 0) == (longest > work.chunk_blocks)
        ct, ntiles, _, _, jb, nwin = plan.meta
        y_plain = scs_spmv_plain(*plan.arrays, x, nrows=n, col_tile=ct, ntiles=ntiles, C=C,
                                 sw=sw, jb=jb, nwin=nwin)
        _rel_close(y, y_plain, dtype, s)
        assert torch.equal(y, scs_spmv_from_plan(plan, x, nrows=n))
        ys[index_dtype] = y
    assert torch.equal(ys["int16"], ys["int32"])


@pytest.mark.cuda
def test_scs_kernel_refuses_plans_it_cannot_stage_on_card(cuda):
    """The kernel copies blocks with 16-byte loads: a plan of jb = 8 and an
    lsl that starts off a 16-byte boundary raise ValueError before any
    launch, and nothing is cached."""
    s = _mat(300, 300, 1)
    x = torch.from_numpy(_x(300)).to(cuda)
    plan, _ = _scs_plans_of_shape(s, 8, 4, 8, device=cuda)
    before = scs_spmv.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        scs_spmv_from_plan(plan, x, nrows=300)
    assert "work" not in plan.cache and scs_spmv.launches == before
    A = tconv.from_dense(s, "csr", device=cuda)
    btile, bwin, lsl, idx2, dat2, perm = A.plan.arrays
    ct, ntiles, C, sw, jb, nwin = A.plan.meta
    shifted = torch.empty(lsl.numel() + 1, dtype=lsl.dtype, device=cuda)[1:]
    shifted.copy_(lsl)
    with pytest.raises(ValueError, match="16-byte"):
        scs_spmv(btile, bwin, shifted, idx2, dat2, perm, x, nrows=300, col_tile=ct,
                 ntiles=ntiles, C=C, sw=sw, jb=jb, nwin=nwin)
    assert scs_spmv.launches == before
    torch.cuda.synchronize()  # the card is still sound


@pytest.mark.cuda
def test_scs_kernel_refuses_a_work_list_of_another_plan(cuda):
    s1, s2 = _mat(300, 300, 1), _mat(600, 300, 2)
    A = tconv.from_dense(s1, "csr", device=cuda)
    B = tconv.from_dense(s2, "csr", device=cuda)
    x = torch.from_numpy(_x(300)).to(cuda)
    scs_spmv_from_plan(B.plan, x, nrows=600)
    ct, ntiles, C, sw, jb, nwin = A.plan.meta
    with pytest.raises(ValueError, match="work list"):
        scs_spmv(*A.plan.arrays, x, nrows=300, col_tile=ct, ntiles=ntiles, C=C, sw=sw,
                 jb=jb, nwin=nwin, work=B.plan.cache["work"])


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


def _dia_arrays(n, m, ndiags, dtype, seed):
    """Raw DIA arrays: ``ndiags`` distinct offsets, most near the main
    diagonal and, from 3 on, two past both ends of the matrix (no row
    reaches them); values everywhere, out-of-range positions included."""
    rng = np.random.default_rng(seed)
    near = rng.choice(np.arange(-70, 71), size=max(ndiags - 2, 1), replace=False)
    far = np.array([-(n + 2), m + 2]) if ndiags >= 3 else np.array([], np.int64)
    offsets = np.sort(np.concatenate([near, far])[:ndiags]).astype(np.int32)
    assert len(np.unique(offsets)) == ndiags
    data = rng.standard_normal((ndiags, n)).astype(np.float32)
    return (torch.from_numpy(offsets),
            torch.from_numpy(data).to(getattr(torch, dtype)))


#: Row counts on both sides of the resident DIA kernel's switch from small
#: CTAs to 256 threads (two CTAs per SM on 132 SMs: 67,329 rows), none a
#: multiple of 32.
DIA_ROWS = [1001, 20001, 67001, 70001]


@pytest.mark.cuda
@pytest.mark.parametrize("ndiags", [1, 7, 27, 33, 125])
@pytest.mark.parametrize("n", DIA_ROWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_resident_kernel_batches_on_card(cuda, ndiags, n, dtype):
    """The resident DIA kernel with the 27-diagonal batch and batches of 8
    with a short last one: equal to its plain version bit for bit in every
    dtype (the same products in the same order, one rounding to the storage
    dtype), with offsets past both ends and x longer or shorter than the
    rows; equal bits over two launches; masked equal to ``where(mask, A @
    x, 0)`` and to the masked plain version, over every row and over the
    mask's row list alike."""
    from repro_torch.kernels.dia_spmv import dia_row_list

    m = n + 37 if n % 3 == 2 else n - 50
    offsets, data = (t.to(cuda) for t in _dia_arrays(n, m, ndiags, dtype, n + ndiags))
    x = torch.from_numpy(_x(m)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(ndiags).random(n) < 0.3).to(cuda)
    before = dia_spmv.launches
    y = dia_spmv(offsets, data, x)
    assert dia_spmv.launches == before + 1
    assert torch.equal(y, dia_spmv_plain(offsets, data, x))
    assert torch.equal(y, dia_spmv(offsets, data, x))
    ym = dia_spmv(offsets, data, x, mask=mask)
    assert torch.equal(ym, torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=cuda)))
    assert torch.equal(ym, dia_spmv_plain(offsets, data, x, mask))
    rows = dia_row_list(mask)
    assert torch.equal(dia_spmv(offsets, data, x, mask, rows=rows), ym)
    assert torch.equal(dia_spmv(offsets, data, x, mask, rows=rows), ym)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [13, 26, 41])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_masked_symgs_colors_on_card(cuda, g, dtype):
    """Every SymGS color of the 27-point stencil (the masks ``SymGS.build``
    makes) through the dispatch entries: masked equal to ``where(mask, A @
    x, 0)`` and to the plain version bit for bit, twice; the adapter checks
    the container once, keeps one row list per mask from ``LIST_MIN_ROWS``
    rows (41^3 = 68,921; rebuilt after an in-place write to the mask) and
    none below, and counts each launch by rows and mask."""
    from repro_torch.core import ExecutionPolicy, as_operator
    from repro_torch.core import matrices as TM
    from repro_torch.kernels.dia_spmv import LIST_MIN_ROWS
    from repro_torch.solvers.symgs import SymGS

    s = TM.fdm27(g, g, g)
    n = s.shape[0]
    D = tconv.from_dense(s, "dia", dtype=dtype, device=cuda)
    masks = SymGS.build(s, operator=as_operator(D)).masks
    assert masks.shape[0] == 8
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
    x = torch.from_numpy(_x(n)).to(cuda)
    y = ops.dia_spmv_cuda(D, x, pol)
    assert "resident" in D.cache
    assert torch.equal(y, dia_spmv_plain(D.offsets, D.data, x))
    before = dia_spmv.by_shape[(n, True)]
    zero = torch.zeros((), dtype=y.dtype, device=cuda)
    for mask in masks:
        ym = ops.dia_masked_spmv_cuda(D, x, mask, pol)
        assert torch.equal(ym, torch.where(mask, y, zero))
        assert torch.equal(ym, dia_spmv_plain(D.offsets, D.data, x, mask))
        assert torch.equal(ym, ops.dia_masked_spmv_cuda(D, x, mask, pol))
    assert dia_spmv.by_shape[(n, True)] == before + 2 * len(masks)
    assert len(D.cache.get("rows", ())) == (len(masks) if n >= LIST_MIN_ROWS else 0)
    mask = masks[0].clone()
    ops.dia_masked_spmv_cuda(D, x, mask, pol)
    mask[: n // 2] = ~mask[: n // 2]  # written in place: the cached list is rebuilt
    assert torch.equal(ops.dia_masked_spmv_cuda(D, x, mask, pol), torch.where(mask, y, zero))


@pytest.mark.cuda
def test_dia_adapter_checks_x_and_mask_on_every_call_on_card(cuda):
    """After the first call has checked and kept the arrays, a mask of the
    wrong shape or dtype, or an x on the host, still raises ``ValueError``
    before any launch."""
    from repro_torch.kernels.dia_spmv import dia_spmv_from_container

    D = tconv.from_dense(_mat(500, 500, 39, "banded"), "dia", device=cuda)
    x = torch.from_numpy(_x(500)).to(cuda)
    y = dia_spmv_from_container(D, x)
    before = dia_spmv.launches
    for bad_x, bad_mask in ((x, torch.ones(499, dtype=torch.bool, device=cuda)),
                            (x, torch.ones(500, dtype=torch.uint8, device=cuda)),
                            (x.cpu(), None)):
        with pytest.raises(ValueError):
            dia_spmv_from_container(D, bad_x, bad_mask)
    assert dia_spmv.launches == before
    assert torch.equal(y, dia_spmv_from_container(D, x))


def _tiles_reached(s, ct):
    """The distinct counts of column tiles that the rows' entries reach."""
    s = s.tocsr()
    return {len(np.unique(s.indices[s.indptr[i]:s.indptr[i + 1]] // ct))
            for i in range(s.shape[0])}


@pytest.mark.cuda
@pytest.mark.parametrize("g,ct", [(16, 384), (41, 2048)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_tiled_kernel_on_the_stencil_on_card(cuda, g, ct, dtype):
    """The tiled kernel on the 27-point stencil (27 slots a tile, of which a
    row needs its diagonals' share: one batch or two), at a column tile
    where rows reach 1, 2 and 3 tiles, in one-warp CTAs (16^3) and CTAs of
    256 (41^3), through the dispatch entries: equal to the plain version
    bit for bit in every dtype, twice; each SymGS color equal to
    ``where(mask, A @ x, 0)`` and to the masked plain version; the plan
    checked once and kept in ``plan.cache``."""
    from repro_torch.core import ExecutionPolicy, as_operator
    from repro_torch.core import matrices as TM
    from repro_torch.solvers.symgs import SymGS

    s = TM.fdm27(g, g, g)
    n = s.shape[0]
    assert {1, 2, 3} <= _tiles_reached(s, ct)
    D = tconv.from_dense(s, "dia", dtype=dtype, col_tile=ct, device=cuda)
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False, max_resident_cols=ct)
    assert ops.cuda_strategy(D, pol) == "tiled" and D.plan.arrays[0].shape[1] == 27
    x = torch.from_numpy(_x(n)).to(cuda)
    before = dia_spmv_tiled.launches
    y = ops.dia_spmv_cuda(D, x, pol)
    assert dia_spmv_tiled.launches == before + 1 and "tiled" in D.plan.cache
    assert torch.equal(y, dia_spmv_tiled_plain(*D.plan.arrays, x, n, ct))
    assert torch.equal(y, ops.dia_spmv_cuda(D, x, pol))
    zero = torch.zeros((), dtype=y.dtype, device=cuda)
    for mask in SymGS.build(s, operator=as_operator(D)).masks:
        ym = ops.dia_masked_spmv_cuda(D, x, mask, pol)
        assert torch.equal(ym, torch.where(mask, y, zero))
        assert torch.equal(ym, dia_spmv_tiled_plain(*D.plan.arrays, x, n, ct, mask))
        assert torch.equal(ym, ops.dia_masked_spmv_cuda(D, x, mask, pol))


def _dia_plan(n, m, offsets, dtype, ct, seed, device):
    """A ``"dia-cols"`` plan of random values on ``offsets``."""
    data = np.random.default_rng(seed).standard_normal((len(offsets), n)).astype(np.float32)
    plan = ttiling.build_dia_col_plan(np.asarray(offsets), data, (n, m), ct)
    return ttiling.plan_to_tensors(plan, getattr(torch, dtype), device)


def _cta_threads(nrows, sms):
    """Threads per CTA that ``spread_threads`` (``csrc/common.cuh``) gives
    a row-per-thread kernel of ``nrows`` rows on ``sms`` SMs."""
    threads = 256
    while threads > 32 and -(-nrows // threads) < 2 * sms:
        threads //= 2
    return threads


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["7_diagonals", "33_diagonals", "125_diagonals", "wide_band",
                                  "128_thread_ctas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_tiled_kernel_batches_on_card(cuda, case, dtype):
    """The tiled kernel at other slot counts than 27 (batches of 8 with a
    short last one), with offsets past both ends of the matrix, x shorter
    or longer than the rows, and a band so wide against the tile
    (``wide_band``: 125 diagonals in +-2000, tiles of 16, 105 slots a
    tile) that a CTA's offsets exceed its 48 KB and it takes its tiles in
    groups; ``128_thread_ctas`` (27 diagonals, 40,001 rows) runs CTAs of
    128 threads on a card of 132 SMs: equal to the plain
    version bit for bit in every dtype, twice, and masked equal to ``where(
    mask, A @ x, 0)`` and to the masked plain version."""
    from repro_torch.kernels.dia_spmv import dia_spmv_tiled_from_plan

    rng = np.random.default_rng(50)
    if case == "wide_band":
        n, m, ct = 3001, 3001, 16
        offsets = np.sort(rng.choice(np.arange(-2000, 2001), 125, replace=False))
    else:
        nd = 27 if case == "128_thread_ctas" else int(case.split("_")[0])
        n, ct = (40001 if nd == 27 else 20001), 64
        m = n + 37 if nd == 7 else n - 50
        near = rng.choice(np.arange(-300, 301), nd - 2, replace=False)
        offsets = np.sort(np.concatenate([near, [-(n + 2), m + 2]]))
    plan = _dia_plan(n, m, offsets, dtype, ct, 51, cuda)
    if case == "wide_band":  # the tiles 256 rows reach, times max_d, pass 48 KB of int32
        assert ((255 + 4000) // ct + 2) * plan.arrays[0].shape[1] > 12288
    if case == "128_thread_ctas":
        assert _cta_threads(n, 132) == 128
    x = torch.from_numpy(_x(m)).to(cuda)
    mask = torch.from_numpy(rng.random(n) < 0.3).to(cuda)
    before = dia_spmv_tiled.launches
    y = dia_spmv_tiled_from_plan(plan, x, n)
    assert dia_spmv_tiled.launches == before + 1
    assert torch.equal(y, dia_spmv_tiled_plain(*plan.arrays, x, n, ct))
    assert torch.equal(y, dia_spmv_tiled_from_plan(plan, x, n))
    ym = dia_spmv_tiled_from_plan(plan, x, n, mask)
    assert torch.equal(ym, torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=cuda)))
    assert torch.equal(ym, dia_spmv_tiled_plain(*plan.arrays, x, n, ct, mask))
    # the wrapper that checks on every call launches the same kernel
    assert torch.equal(y, dia_spmv_tiled(*plan.arrays, x, nrows=n, col_tile=ct))


@pytest.mark.cuda
def test_dia_tiled_adapter_checks_x_and_mask_on_every_call_on_card(cuda):
    """After the first call has checked and kept the plan, a mask of the
    wrong shape or dtype, an x on the host, or another row count still
    raises ``ValueError`` before any launch."""
    from repro_torch.kernels.dia_spmv import dia_spmv_tiled_from_plan

    D = tconv.from_dense(_mat(500, 500, 52, "banded"), "dia", col_tile=32, device=cuda)
    x = torch.from_numpy(_x(500)).to(cuda)
    y = dia_spmv_tiled_from_plan(D.plan, x, 500)
    before = dia_spmv_tiled.launches
    for bad_x, bad_mask, rows in ((x, torch.ones(499, dtype=torch.bool, device=cuda), 500),
                                  (x, torch.ones(500, dtype=torch.uint8, device=cuda), 500),
                                  (x.cpu(), None, 500), (x, None, 499)):
        with pytest.raises(ValueError):
            dia_spmv_tiled_from_plan(D.plan, bad_x, rows, bad_mask)
    assert dia_spmv_tiled.launches == before
    assert torch.equal(y, dia_spmv_tiled_from_plan(D.plan, x, 500))


def _ell_arrays(n, m, width, dtype, seed):
    """Raw resident ELL arrays: each slot an id in [0, m) or a -1 pad
    anywhere in the row (not packed left), values everywhere, pads
    included."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, size=(n, width)).astype(np.int32)
    idx[rng.random((n, width)) < 0.3] = -1
    data = rng.standard_normal((n, width)).astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(data).to(getattr(torch, dtype))


def _shifted(t, dev):
    """A copy of ``t`` on ``dev`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 27, 33, 64])
@pytest.mark.parametrize("n", [301, 1001, 40001])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ell_resident_kernel_on_card(cuda, width, n, dtype):
    """The resident ELL wrapper runs the tiled kernel's case of one tile:
    equal to its plain version bit for bit in every dtype (pad values never
    added), with odd n x W, W above the 32 slots staged at a time, ids and
    values that start off a 16-byte boundary, equal bits over two launches,
    masked equal to ``where(mask, A @ x, 0)``; an index of other indices
    raises ``ValueError``."""
    m = 3 * n // 2 + 1
    idx, data = (t.to(cuda) for t in _ell_arrays(n, m, width, dtype, n + width))
    x = torch.from_numpy(_x(m)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(width).random(n) < 0.5).to(cuda)
    listed = ell_tile_index(idx.unsqueeze(0))
    before = ell_spmv.launches
    y = ell_spmv(idx, data, x, tile_index=listed)
    assert ell_spmv.launches == before + 1
    assert torch.equal(y, ell_spmv_plain(idx, data, x))
    assert torch.equal(y, ell_spmv(idx, data, x, tile_index=listed))
    assert torch.equal(y, ell_spmv(idx, data, x))  # the index built here
    zero = torch.zeros((), dtype=y.dtype, device=cuda)
    assert torch.equal(ell_spmv(idx, data, x, mask=mask, tile_index=listed),
                       torch.where(mask, y, zero))
    si, sd = _shifted(idx, cuda), _shifted(data, cuda)
    assert torch.equal(ell_spmv(si, sd, x), y)
    with pytest.raises(ValueError, match="tile_index"):
        ell_spmv(si, sd, x, tile_index=listed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ell_resident_entry_on_the_stencil_on_card(cuda, dtype):
    """Through dispatch on 26^3 (W = 27): the ELL entry caches the one-tile
    index on the container once, equals the plain version, and the masked
    entry equals ``where(mask, A @ x, 0)`` for every SymGS color."""
    from repro_torch.core import ExecutionPolicy
    from repro_torch.core import matrices as TM
    from repro_torch.solvers.symgs import greedy_coloring

    s = TM.fdm27(26, 26, 26)
    n = s.shape[0]
    E = tconv.from_dense(s, "ell", dtype=dtype, device=cuda)
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False)
    assert ops.cuda_strategy(E, pol) == "resident"
    x = torch.from_numpy(_x(n)).to(cuda)
    y = ops.ell_spmv_cuda(E, x, pol)
    listed = E.cache["tile_index"]
    assert torch.equal(y, ell_spmv_plain(E.indices, E.data, x))
    assert ops.ell_spmv_cuda(E, x, pol) is not y and E.cache["tile_index"] is listed
    colors = torch.from_numpy(greedy_coloring(s)).to(cuda)
    zero = torch.zeros((), dtype=y.dtype, device=cuda)
    for c in range(int(colors.max()) + 1):
        mask = colors == c
        assert torch.equal(ops.ell_masked_spmv_cuda(E, x, mask, pol),
                           torch.where(mask, y, zero))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(3000, 5000)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index_dtype", ["int8", "int16", "int32"])
def test_ell_kernels_match_plain_on_card(cuda, shape, dtype, index_dtype):
    """Resident, tiled and masked ELL kernels equal their plain versions in
    every dtype (the same products in the same order, one rounding to the
    storage dtype at the end), narrow ids equal int32, and two launches
    are bit-equal."""
    n, m = shape
    s = _mat(n, m, 17)
    E = tconv.from_dense(s, "ell", dtype=dtype, col_tile=64, index_dtype=index_dtype,
                         device=cuda)
    x = torch.from_numpy(_x(m)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(9).random(n) < 0.5).to(cuda)
    before = (ell_spmv.launches, ell_spmv_tiled.launches)
    y = ell_spmv(E.indices, E.data, x)
    yt = ell_spmv_tiled(*E.plan.arrays, x, col_tile=64)
    assert (ell_spmv.launches, ell_spmv_tiled.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, ell_spmv_plain(E.indices, E.data, x))
    assert torch.equal(yt, ell_spmv_tiled_plain(*E.plan.arrays, x, col_tile=64))
    assert torch.equal(yt, ell_spmv_tiled(*E.plan.arrays, x, col_tile=64))
    zero = torch.zeros((), dtype=y.dtype, device=cuda)
    assert torch.equal(ell_spmv(E.indices, E.data, x, mask=mask), torch.where(mask, y, zero))
    assert torch.equal(ell_spmv_tiled(*E.plan.arrays, x, col_tile=64, mask=mask),
                       torch.where(mask, yt, zero))
    if index_dtype != "int32":
        E32 = tconv.from_dense(s, "ell", dtype=dtype, col_tile=64, index_dtype="int32",
                               device=cuda)
        assert torch.equal(yt, ell_spmv_tiled(*E32.plan.arrays, x, col_tile=64))


@pytest.mark.cuda
@pytest.mark.parametrize("col_tile,index_dtype", ELL_INDEX_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ell_listed_kernel_on_card(cuda, col_tile, index_dtype, dtype):
    """The tiled ELL kernel walks only the listed tiles of each chunk (an
    empty chunk, tiles that are not adjacent, a ragged last chunk, W > 32
    staged in segments) and equals its plain version bit for bit in every
    dtype, masked equals ``where(mask, A @ x, 0)``, narrow ids equal int32,
    and two launches are bit-equal; so does a plan whose rows' slots are
    not packed left."""
    s = _ell_index_matrix(col_tile)
    n, m = s.shape
    E = tconv.from_dense(s, "ell", dtype=dtype, col_tile=col_tile, index_dtype=index_dtype,
                         device=cuda)
    idx_t, dat_t = E.plan.arrays
    x = torch.from_numpy(_x(m)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(9).random(n) < 0.5).to(cuda)
    listed = ell_tile_index(idx_t)
    before = ell_spmv_tiled.launches
    y = ell_spmv_tiled(idx_t, dat_t, x, col_tile=col_tile, tile_index=listed)
    assert ell_spmv_tiled.launches == before + 1
    assert torch.equal(y, ell_spmv_tiled_plain(idx_t, dat_t, x, col_tile))
    assert torch.equal(y, ell_spmv_tiled(idx_t, dat_t, x, col_tile=col_tile))
    zero = torch.zeros((), dtype=y.dtype, device=cuda)
    assert torch.equal(ell_spmv_tiled(idx_t, dat_t, x, col_tile=col_tile, mask=mask,
                                      tile_index=listed), torch.where(mask, y, zero))
    E32 = tconv.from_dense(s, "ell", dtype=dtype, col_tile=col_tile, index_dtype="int32",
                           device=cuda)
    assert torch.equal(y, ell_spmv_tiled(*E32.plan.arrays, x, col_tile=col_tile))
    fi, fd = idx_t.flip(-1).contiguous(), dat_t.flip(-1).contiguous()
    assert torch.equal(ell_spmv_tiled(fi, fd, x, col_tile=col_tile),
                       ell_spmv_tiled_plain(fi, fd, x, col_tile))


@pytest.mark.cuda
@pytest.mark.parametrize("ntiles,ct", [(2, 64), (1, 64)])
def test_resident_ell_entry_refuses_tiles_on_card(cuda, ntiles, ct):
    """``ell_spmv`` runs only the resident arrays (one tile, global ids):
    the tile index of an ``"ell-cols"`` plan (two tiles, or one of width
    ``ct``) raises ``ValueError`` instead of launching."""
    s = _mat(64, 64 * ntiles, 3)
    E = tconv.from_dense(s, "ell", col_tile=ct, device=cuda)
    assert E.plan.ntiles == ntiles
    x = torch.from_numpy(_x(64 * ntiles)).to(cuda)
    before = ell_spmv.launches
    with pytest.raises(ValueError, match="tile_index"):
        ell_spmv(E.indices, E.data, x, tile_index=ell_tile_index(E.plan.arrays[0]))
    assert ell_spmv.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(3000, 5000)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index_dtype", ["int8", "int16", "int32"])
def test_coo_kernels_match_plain_on_card(cuda, shape, dtype, index_dtype):
    """The full-window COO kernel equals its plain version; the sliced one
    agrees with its plain version within the stated tolerance (same-row
    sums reassociated by the warp scan), repeats bit for bit, and gives
    the int32 result with narrow ids."""
    n, m = shape
    s = _mat(n, m, 18)
    C = tconv.from_dense(s, "coo", dtype=dtype, col_tile=64, index_dtype=index_dtype,
                         pad_to=64, device=cuda)
    x = torch.from_numpy(_x(m)).to(cuda)
    before = (coo_spmv.launches, scoo_spmv_tiled.launches)
    y = coo_spmv(C.row, C.col, C.val, x, nrows=n)
    row, col, val, sid, ctile = C.plan.arrays
    ct, _, slice_rows, tile = C.plan.meta
    yt = scoo_spmv_tiled(row, col, val, sid, ctile, x, nrows=n, col_tile=ct,
                         slice_rows=slice_rows, tile=tile)
    assert (coo_spmv.launches, scoo_spmv_tiled.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, coo_spmv_plain(C.row, C.col, C.val, x, nrows=n))
    _rel_close(yt, scoo_spmv_tiled_plain(row, col, val, sid, ctile, x, nrows=n,
                                         col_tile=ct, tile=tile), dtype, s)
    assert torch.equal(yt, scoo_spmv_tiled(row, col, val, sid, ctile, x, nrows=n,
                                           col_tile=ct, slice_rows=slice_rows, tile=tile))
    if index_dtype != "int32":
        C32 = tconv.from_dense(s, "coo", dtype=dtype, col_tile=64, index_dtype="int32",
                               device=cuda)
        r32, c32, v32, sid32, ct32 = C32.plan.arrays
        assert torch.equal(yt, scoo_spmv_tiled(r32, c32, v32, sid32, ct32, x, nrows=n,
                                               col_tile=ct, slice_rows=slice_rows,
                                               tile=tile))


def _coo_case(case):
    """A scipy matrix for the full-window kernel: ``stencil`` (13^3, CTAs of
    one warp), ``empty_rows`` (every fifth row empty), ``long_rows`` (a row
    of 5,000 entries and a CTA of 32 rows holding 2,800: ranges longer than
    the 2,048-entry stage) and ``widest_ctas`` (70,001 rows: CTAs of 64,
    the kernel's widest)."""
    import scipy.sparse as sp

    from repro_torch.core import matrices as TM

    if case == "stencil":
        return TM.fdm27(13, 13, 13)
    rng = np.random.default_rng(53)
    if case == "empty_rows":
        s = _mat(3000, 2000, 54)
        s = sp.csr_matrix(sp.diags((np.arange(3000) % 5 != 1).astype(np.float64)) @ s)
        s.eliminate_zeros()
        return s
    if case == "long_rows":
        n, m = 600, 8000
        rows, cols = [np.full(5000, 5)], [rng.choice(m, 5000, replace=False)]
        for r in range(100, 128):
            rows.append(np.full(100, r))
            cols.append(rng.choice(m, 100, replace=False))
        rows.append(rng.integers(0, n, 2000))
        cols.append(rng.integers(0, m, 2000))
        r, c = np.concatenate(rows), np.concatenate(cols)
        s = sp.csr_matrix((rng.standard_normal(r.size), (r, c)), shape=(n, m))
        s.sum_duplicates()
        return s
    return _mat(70001, 5000, 55, density=0.002)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stencil", "empty_rows", "long_rows", "widest_ctas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_coo_full_window_kernel_on_card(cuda, case, dtype):
    """The full-window kernel, through the dispatch entry and on arrays off
    a 16-byte boundary (its scalar loads), with tail sentinels: equal to
    its plain version bit for bit in every dtype, twice; the container
    checked once and kept in ``A.cache``; each launch counted."""
    from repro_torch.core import ExecutionPolicy

    s = _coo_case(case)
    n, m = s.shape
    pol = ExecutionPolicy(backends=("cuda",), allow_fallback=False, max_onehot_rows=1 << 17)
    C = tconv.from_dense(s, "coo", dtype=dtype, pad_to=64, device=cuda)
    assert ops.cuda_strategy(C, pol) == "resident" and C.nnz % 64 == 0
    x = torch.from_numpy(_x(m)).to(cuda)
    before = coo_spmv.launches
    y = ops.coo_spmv_cuda(C, x, pol)
    assert coo_spmv.launches == before + 1 and "rows" in C.cache
    want = coo_spmv_plain(C.row, C.col, C.val, x, nrows=n)
    assert torch.equal(y, want)
    assert torch.equal(y, ops.coo_spmv_cuda(C, x, pol))
    # the same entries one element off the arrays' start: scalar loads
    row, col, val = (torch.cat([t[:1], t]).clone()[1:] for t in (C.row, C.col, C.val))
    assert col.data_ptr() % 16 != 0
    assert torch.equal(coo_spmv(row, col, val, x, nrows=n), want)


@pytest.mark.cuda
def test_coo_adapter_checks_x_on_every_call_on_card(cuda):
    """After the first call has checked and kept the container, an x on
    the host or not a contiguous vector still raises ``ValueError`` before
    any launch."""
    from repro_torch.kernels.coo_spmv import coo_spmv_from_container

    C = tconv.from_dense(_mat(500, 400, 56), "coo", device=cuda)
    x = torch.from_numpy(_x(400)).to(cuda)
    y = coo_spmv_from_container(C, x)
    before = coo_spmv.launches
    for bad in (x.cpu(), torch.stack([x, x], 1)[:, 0], x[None]):
        with pytest.raises(ValueError):
            coo_spmv_from_container(C, bad)
    assert coo_spmv.launches == before
    assert torch.equal(y, coo_spmv_from_container(C, x))


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", ["int8", "int16", "int32"])
def test_scoo_kernel_keeps_first_row_beside_pad_run_on_card(cuda, index_dtype):
    """A (slice, tile) group of fewer than 32 entries puts the slice's first
    row, other rows and the pad run (rows = the slice's first row) into one
    warp step; the pad run's sum must not overwrite the real one."""
    import scipy.sparse as sp

    n, m = 512, 128
    rng = np.random.default_rng(19)
    dense = np.zeros((n, m))
    dense[:, :64] = (rng.random((n, 64)) < 0.05) * rng.standard_normal((n, 64))
    dense[0, 100], dense[1, 100] = 1.5, -2.0  # the second tile's only entries
    s = sp.csr_matrix(dense)
    C = tconv.from_dense(s, "coo", col_tile=64, index_dtype=index_dtype, device=cuda)
    row, col, val, sid, ctile = C.plan.arrays
    ct, _, slice_rows, tile = C.plan.meta
    x = torch.from_numpy(_x(m)).to(cuda)
    yt = scoo_spmv_tiled(row, col, val, sid, ctile, x, nrows=n, col_tile=ct,
                         slice_rows=slice_rows, tile=tile)
    _rel_close(yt, scoo_spmv_tiled_plain(row, col, val, sid, ctile, x, nrows=n,
                                         col_tile=ct, tile=tile), "float32", s)
    _close(yt.cpu().numpy(), s @ _x(m))
    C32 = tconv.from_dense(s, "coo", col_tile=64, index_dtype="int32", device=cuda)
    assert torch.equal(yt, scoo_spmv_tiled(*C32.plan.arrays, x, nrows=n, col_tile=ct,
                                           slice_rows=slice_rows, tile=tile))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(3000, 5000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scoo_spmv_kernel_matches_plain_on_card(cuda, shape, dtype):
    """The sliced kernel over a ``build_scoo`` layout (global ids, no
    column tiles) agrees with its plain version within the stated
    tolerance and repeats bit for bit."""
    n, m = shape
    s = _mat(n, m, 25)
    arrays = [torch.from_numpy(a).to(cuda) for a in _scoo_arrays(s, dtype, 64, 128)]
    arrays[2] = arrays[2].to(getattr(torch, dtype))
    x = torch.from_numpy(_x(m)).to(cuda)
    before = scoo_spmv.launches
    y = scoo_spmv(*arrays, x, nrows=n, slice_rows=64, tile=128)
    assert scoo_spmv.launches == before + 1
    assert y.dtype == getattr(torch, dtype)
    _rel_close(y, scoo_spmv_plain(*arrays, x, nrows=n), dtype, s)
    assert torch.equal(y, scoo_spmv(*arrays, x, nrows=n, slice_rows=64, tile=128))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(64,), (64, 65), (64, 65, 66, 100)])
def test_scoo_spmv_kernel_keeps_first_row_beside_pad_run_on_card(cuda, rows):
    """``build_scoo`` pads a slice with entries on its first row and value
    0. A slice whose few entries sit on its first row and beside it shares
    one warp step with that pad run; the pad run's sum must not overwrite
    the real one."""
    import scipy.sparse as sp

    n, m = 512, 128
    rng = np.random.default_rng(26)
    dense = np.zeros((n, m))
    dense[:64] = (rng.random((64, m)) < 0.05) * rng.standard_normal((64, m))
    for r in rows:  # slice 1 (rows 64..127) holds only these entries
        dense[r, [3, 90]] = rng.standard_normal(2)
    s = sp.csr_matrix(dense)
    arrays = [torch.from_numpy(a).to(cuda) for a in _scoo_arrays(s, "float32", 64, 64)]
    x = torch.from_numpy(_x(m)).to(cuda)
    y = scoo_spmv(*arrays, x, nrows=n, slice_rows=64, tile=64)
    _rel_close(y, scoo_spmv_plain(*arrays, x, nrows=n), "float32", s)
    _close(y.cpu().numpy(), s @ _x(m))
    assert torch.equal(y, scoo_spmv(*arrays, x, nrows=n, slice_rows=64, tile=64))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["csc", "shuffled"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scoo_spmv_kernel_in_any_entry_order_on_card(cuda, order, dtype):
    """Slices whose entries are not sorted by row (a column-major or
    shuffled COO through ``build_scoo``): a row recurs in several runs of
    one warp step, and every run's sum must reach it."""
    n, m = 3000, 500
    s = _mat(n, m, 29)
    row, col, data = _coo_in_order(s, order)
    arrays = [torch.from_numpy(a).to(cuda) for a in build_scoo(
        row, col, data.astype(ttiling.staging_dtype(dtype)), n, 64, 128)]
    arrays[2] = arrays[2].to(getattr(torch, dtype))
    x = torch.from_numpy(_x(m)).to(cuda)
    y = scoo_spmv(*arrays, x, nrows=n, slice_rows=64, tile=128)
    _rel_close(y, scoo_spmv_plain(*arrays, x, nrows=n), dtype, s)
    assert torch.equal(y, scoo_spmv(*arrays, x, nrows=n, slice_rows=64, tile=128))


def _split_slice_matrix(case):
    """``(scipy matrix, slice_rows, tile)`` for the sliced COO kernel's
    split of a slice across warps: ``"long_row"`` has a slice of 180
    blocks (``build_scoo``) whose row 70 holds 5,000 entries, which
    straddle the warps' shares; ``"one_block"`` slices of at most one block; ``"empty_slice"``
    slices with no entries beside full ones; ``"max_slice_rows"`` slices of
    ``MAX_SLICE_ROWS`` rows (fewer warps, larger windows)."""
    import scipy.sparse as sp

    from repro_torch.kernels.coo_spmv import MAX_SLICE_ROWS

    rng = np.random.default_rng(33)
    if case == "long_row":
        n, m, slice_rows, tile = 256, 6000, 64, 32
        s = sp.random(n, m, density=0.002, random_state=rng, format="lil")
        s[70, rng.choice(m, 5000, replace=False)] = rng.standard_normal(5000)
    elif case == "one_block":
        n, m, slice_rows, tile = 512, 300, 64, 128
        s = sp.random(n, m, density=0.002, random_state=rng, format="lil")
    elif case == "empty_slice":
        n, m, slice_rows, tile = 512, 300, 64, 32
        s = sp.random(n, m, density=0.05, random_state=rng, format="lil")
        s[64:192] = 0
    else:
        n, m, slice_rows, tile = 2 * MAX_SLICE_ROWS + 100, 700, MAX_SLICE_ROWS, 512
        s = sp.random(n, m, density=0.01, random_state=rng, format="lil")
    s = sp.csr_matrix(s)
    s.data = rng.standard_normal(s.nnz)
    return s, slice_rows, tile


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_row", "one_block", "empty_slice", "max_slice_rows"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("kernel", ["scoo_spmv", "scoo_spmv_tiled"])
def test_scoo_kernels_split_slices_across_warps_on_card(cuda, case, order, kernel):
    """Both sliced COO kernels, each slice's run of blocks cut across the
    warps of its CTA: within tolerance of the plain version and of scipy,
    equal bits over two launches, int16 ids equal to int32, with the pad
    runs and with entries shuffled inside each block (``scoo_spmv_tiled``)
    or each slice (``scoo_spmv``)."""
    s, slice_rows, tile = _split_slice_matrix(case)
    n, m = s.shape
    x = torch.from_numpy(_x(m)).to(cuda)
    coo = s.tocoo()
    rng = np.random.default_rng(34)
    perm = rng.permutation(coo.nnz) if order == "shuffled" else np.lexsort((coo.col, coo.row))
    row, col, val = coo.row[perm], coo.col[perm], coo.data[perm].astype(np.float32)
    if kernel == "scoo_spmv":
        arrays = [torch.from_numpy(a).to(cuda)
                  for a in build_scoo(row, col, val, n, slice_rows, tile)]
        if order == "shuffled":
            assert bool((arrays[0][1:] < arrays[0][:-1]).any())

        def run(a=arrays):
            return scoo_spmv(*a, x, nrows=n, slice_rows=slice_rows, tile=tile)

        plain, runs = scoo_spmv_plain(*arrays, x, nrows=n), [run]
    else:
        col_tile = 256
        runs, at = [], None
        for idt in ("int16", "int32"):
            plan = ttiling.build_coo_col_plan(row, col, val, (n, m), col_tile, slice_rows, tile,
                                              index_dtype=idt)
            r, c, v, sid, ctile = (np.array(a) for a in plan.arrays)
            if order == "shuffled":  # entries in any order inside each block, alike for both
                if at is None:
                    within = np.argsort(rng.random(r.shape[0]).reshape(-1, tile), axis=1)
                    at = (within + np.arange(0, r.shape[0], tile)[:, None]).reshape(-1)
                r, c, v = r[at], c[at], v[at]
            a = [torch.from_numpy(u).to(cuda) for u in (r, c, v, sid, ctile)]
            runs.append(lambda a=a: scoo_spmv_tiled(*a, x, nrows=n, col_tile=col_tile,
                                                    slice_rows=slice_rows, tile=tile))
        plain = scoo_spmv_tiled_plain(*a, x, nrows=n, col_tile=col_tile, tile=tile)
    y = runs[0]()
    _rel_close(y, plain, "float32", s)
    _close(y.cpu().numpy(), s @ _x(m))
    assert all(torch.equal(y, fn()) for fn in runs)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("nf", [1, 5, 8, 16, 128, 130])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bsr_kernel_matches_plain_on_card(cuda, bs, nf, dtype):
    """``bsr_spmm`` against its plain version (rtol 2e-4 in f32: the kernel
    adds in 3xTF32 on the tensor cores or with fused multiply-adds, the
    plain version through a matmul), with a block id past the last block
    column; two launches give equal bits; the row mask gives ``where(mask,
    Y, 0)`` exactly. Both paths of the kernel are met: the tensor cores at
    bs >= 16 and nf >= 8, the CUDA cores otherwise."""
    s, bcols, blocks, X = _bsr_operands(3000, 5000 if bs < 64 else 2000, bs, nf, dtype)
    bcols, blocks = bcols.to(cuda), blocks.to(cuda)
    X = torch.from_numpy(X).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(27).random(bcols.shape[0] * bs)
                            < 0.5).to(cuda)
    mask[:bs] = False  # one block row masked whole: it reads nothing
    before = bsr_spmm.launches
    Y = bsr_spmm(bcols, blocks, X)
    assert bsr_spmm.launches == before + 1
    assert Y.dtype == torch.float32 and Y.shape == (bcols.shape[0] * bs, nf)
    _close(Y.cpu().numpy(), bsr_spmm_plain(bcols, blocks, X).cpu().numpy())
    assert torch.equal(Y, bsr_spmm(bcols, blocks, X))
    Ym = bsr_spmm(bcols, blocks, X, row_mask=mask)
    assert torch.equal(Ym, torch.where(mask[:, None], Y, torch.zeros((), device=cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_bsr_entries_on_card(cuda, bs):
    """Through dispatch: the bsr/cuda SpMV equals column 0 of the SpMM of
    one column, the masked SpMV equals ``where(mask, A @ x, 0)`` exactly,
    and both agree with csr/plain."""
    from repro_torch.core import as_operator

    s = _mat(1000, 900, 28)
    A = as_operator(s, "bsr", bs=bs, device=cuda).using("cuda", fallback=False)
    x = torch.from_numpy(_x(900)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(29).random(1000) < 0.5).to(cuda)
    before = bsr_spmm.launches
    y = A @ x
    ym = A.masked_matvec(x, mask)
    assert bsr_spmm.launches == before + 2
    assert torch.equal(ym, torch.where(mask, y, torch.zeros((), device=cuda)))
    _close(y.cpu().numpy(), s @ _x(900))


@pytest.mark.cuda
@pytest.mark.parametrize("nf", [1, 16])
def test_bsr_kernel_takes_an_unaligned_x_on_card(cuda, nf):
    """X that starts off a 16-byte boundary (a view at an offset) gives the
    result of an aligned copy bit for bit."""
    s, bcols, blocks, X = _bsr_operands(500, 400, 32, nf, "float32")
    bcols, blocks = bcols.to(cuda), blocks.to(cuda)
    buf = torch.empty(X.size + 1, device=cuda)
    Xv = buf[1:].view(X.shape)
    Xv.copy_(torch.from_numpy(X))
    assert Xv.data_ptr() % 16
    assert torch.equal(bsr_spmm(bcols, blocks, Xv),
                       bsr_spmm(bcols, blocks, torch.from_numpy(X).to(cuda)))


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

    monkeypatch.setattr(ops, "dia_spmv_from_container", broken)
    A = as_operator(_mat(64, 64, 1, "banded"), "dia", device=cuda).using("cuda")
    with pytest.raises(KernelExecutionError):
        A @ torch.ones(64, device=cuda)
