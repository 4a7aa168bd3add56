"""The port's distributed SpMV layer and distributed HPCG against the JAX
reference on the CPU.

Host-side numpy (row partitions, the local/remote split, row blocks, the
part containers, ``distributable_depth``) must equal the reference exactly.
The operator runs on ``PartMesh.on("cpu", parts=4)``; the reference runs the
same inputs on four fake host devices in one subprocess (``run_py``) and
hands its outputs over in an ``.npz``. Both are held to the dense oracle at
the reference's own bound, ``1e-5 * max|y|``, and to each other's
structure (``describe``, ``format``, ``halo``, ``nbytes``, the groups).
Inside the port, ``rowblock`` csr/plain equals the serial csr/plain SpMV
bit for bit.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core.distributed as JD
import repro.solvers as JS
from conftest import run_py
from repro.core import matrices as M

import repro_torch.solvers as TS
from repro_torch.apps.hpcg import default_mesh, run_hpcg_distributed
from repro_torch.core import DispatchKey, ExecutionPolicy, PartMesh, SparseOperator
from repro_torch.core import as_operator as t_as_operator
from repro_torch.core import distributed as TD
from repro_torch.distributed_op import (
    DISTRIBUTED_CANDIDATES,
    STACKABLE_FORMATS,
    DistributedOperator,
    as_dispatch_key,
    distribute,
    tune_partitions,
)
from repro_torch.distributed_op.operator import _per_part_keys

MESH4 = PartMesh.on("cpu", parts=4)


def _rect(nx, ny, nz):
    """The injection restriction R (nc x nf) and prolongation P = R^T."""
    f2c = M.coarsen_injection(nx, ny, nz)
    nc, nf = len(f2c), nx * ny * nz
    R = sp.csr_matrix((np.ones(nc), (np.arange(nc), f2c)), shape=(nc, nf))
    return R, R.T.tocsr()


def _same_csr(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == b.data.dtype


# ------------------------------------------------------ host-side, exact ----


@pytest.mark.parametrize("n,nparts,even", [
    (8, 4, True), (6, 1, True), (0, 3, True), (10, 4, False), (2, 4, False),
    (7, 3, False), (1124864, 4, True), (17576, 4, True)])
def test_partition_rows_equal_reference(n, nparts, even):
    assert TD.partition_rows(n, nparts, even) == JD.partition_rows(n, nparts, even)


@pytest.mark.parametrize("n,nparts,match", [(7, 4, "divisible"), (2, 4, "divisible"),
                                            (8, 0, "positive"), (8, -1, "positive"),
                                            (-1, 2, "non-negative")])
def test_partition_rows_errors(n, nparts, match):
    with pytest.raises(ValueError, match=match):
        JD.partition_rows(n, nparts)
    with pytest.raises(ValueError, match=match):
        TD.partition_rows(n, nparts)


def _auto_halo(s, nparts):
    return JD.split_local_remote(s, nparts)[2]


@pytest.mark.parametrize("grid", [(4, 4, 8), (8, 8, 8), (16, 16, 16)])
@pytest.mark.parametrize("nparts", [1, 2, 4])
@pytest.mark.parametrize("halo", ["auto", None, "int"])
def test_split_local_remote_equal_reference(grid, nparts, halo):
    s = M.fdm27(*grid)
    if halo == "int":  # an explicit window wider than the reach it needs
        auto = _auto_halo(s, nparts)
        halo = 2 if auto is None else auto + 3
    jl, jr, jh = JD.split_local_remote(s, nparts, halo=halo)
    tl, tr, th = TD.split_local_remote(s, nparts, halo=halo)
    assert th == jh
    for a, b in zip(tl + tr, jl + jr):
        _same_csr(a, b)


@pytest.mark.parametrize("which", ["R", "P"])
@pytest.mark.parametrize("halo", ["auto", None])
def test_split_local_remote_rectangular_equal_reference(which, halo):
    """The z-major injection is part-aligned: its remote blocks are empty."""
    m = dict(zip("RP", _rect(4, 4, 8)))[which]
    jl, jr, jh = JD.split_local_remote(m, 4, halo=halo)
    tl, tr, th = TD.split_local_remote(m, 4, halo=halo)
    assert th == jh and sum(r.nnz for r in tr) == 0
    for a, b in zip(tl + tr, jl + jr):
        _same_csr(a, b)


def test_split_local_remote_noncanonical_equal_reference():
    """Explicit zeros and unsorted rows: the local blocks keep the storage
    order, the remote blocks come out canonical, as the reference's."""
    u = M.fdm27(4, 4, 4).tocsr().copy()
    u.data[::7] = 0.0
    for r in range(u.shape[0]):
        a, b = u.indptr[r], u.indptr[r + 1]
        u.indices[a:b] = u.indices[a:b][::-1].copy()
        u.data[a:b] = u.data[a:b][::-1].copy()
    u.has_sorted_indices = False
    for nparts in (2, 4):
        jl, jr, jh = JD.split_local_remote(u, nparts)
        tl, tr, th = TD.split_local_remote(u, nparts)
        assert th == jh
        for a, b in zip(tl + tr, jl + jr):
            _same_csr(a, b)


def test_split_local_remote_window_too_narrow_raises():
    with pytest.raises(ValueError, match="halo window"):
        TD.split_local_remote(M.fdm27(8, 8, 8), 4, halo=3)


@pytest.mark.parametrize("grid,nparts", [((8, 8, 8), 4), ((4, 4, 8), 2), ((16, 16, 16), 4)])
def test_split_rowblocks_equal_reference(grid, nparts):
    s = M.fdm27(*grid)
    for a, b in zip(TD.split_rowblocks(s, nparts), JD.split_rowblocks(s, nparts)):
        _same_csr(a, b)


_CONTAINER_FIELDS = {"coo": ("row", "col", "val"), "csr": ("indptr", "indices", "data"),
                     "dia": ("offsets", "data"), "ell": ("indices", "data")}


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia", "ell"])
@pytest.mark.parametrize("block", ["local", "remote", "mixed"])
def test_build_stacked_parts_equal_reference_leaves(fmt, block):
    """Part ``p``'s arrays equal the reference's stacked leaves ``[p]``, and
    the bytes add up to the stacked bytes."""
    locals_, remotes, _ = JD.split_local_remote(M.fdm27(8, 8, 8), 4)
    mats = {"local": locals_, "remote": remotes,
            "mixed": [remotes[0], sp.csr_matrix(remotes[1].shape), remotes[2],
                      sp.csr_matrix(remotes[3].shape)]}[block]
    ref = JD.build_stacked(mats, fmt, jnp.float32)
    parts = TD.build_stacked(mats, fmt, torch.float32, device="cpu")
    assert len(parts) == 4
    ref_bytes = sum(np.asarray(getattr(ref, f)).nbytes for f in _CONTAINER_FIELDS[fmt])
    assert sum(SparseOperator(c).nbytes for c in parts) == ref_bytes
    for p, c in enumerate(parts):
        assert tuple(c.shape) == tuple(ref.shape) and c.plan is None
        for f in _CONTAINER_FIELDS[fmt]:
            np.testing.assert_array_equal(getattr(c, f).numpy(), np.asarray(getattr(ref, f))[p])
        if fmt == "dia":
            assert c.extent == ref.extent


@pytest.mark.parametrize("fmt,grow", [("coo", 7), ("csr", 7), ("dia", 3)])
def test_padding_round_trip(fmt, grow):
    """``_pad_*`` is invisible to ``to_dense``, and padding to the current
    size (or less) is the identity."""
    from repro_torch.core import from_dense

    c = from_dense(M.banded(16, 2, seed=5), fmt, device="cpu")
    pad = {"coo": TD._pad_coo, "csr": TD._pad_csr, "dia": TD._pad_dia}[fmt]
    size = c.ndiags if fmt == "dia" else c.nnz
    assert torch.equal(pad(c, size + grow).to_dense(), c.to_dense())
    assert pad(c, 0) is c


@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 8])
def test_distributable_depth_equal_reference(nparts):
    for g in [(4, 4, 8), (6, 6, 6), (8, 8, 8), (12, 12, 12), (16, 16, 16), (26, 26, 26),
              (52, 52, 52), (104, 104, 104), (16, 8, 4), (10, 10, 10)]:
        for depth in (1, 3, 4):
            try:
                want = JS.distributable_depth(*g, nparts, depth=depth)
            except ValueError:
                with pytest.raises(ValueError, match="not divisible"):
                    TS.distributable_depth(*g, nparts, depth=depth)
                continue
            assert TS.distributable_depth(*g, nparts, depth=depth) == want, (g, depth)
    assert TS.distributable_depth(104, 104, 104, 4) == 3


# ----------------------------------------------------------- the mesh ----


def test_part_mesh_and_default_mesh():
    assert MESH4.shape == {"data": 4} and MESH4.home == torch.device("cpu")
    assert default_mesh("data", "cpu").shape["data"] == 1
    assert default_mesh("rows", "cpu", parts=4).shape == {"rows": 4}
    with pytest.raises(ValueError, match="positive"):
        PartMesh.on("cpu", parts=0)
    with pytest.raises(ValueError, match="axis"):
        DistributedOperator.build(M.fdm27(4, 4, 4), MESH4, "model")


def test_part_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        PartMesh.on("cuda", parts=4)
    with pytest.raises(RuntimeError, match="cuda"):
        default_mesh()


def test_keys_and_groups():
    assert as_dispatch_key("dia") == DispatchKey("dia", "plain")
    assert as_dispatch_key(("ell", "cuda")) == DispatchKey("ell", "cuda")
    assert _per_part_keys(("csr", "cuda"), 3) == (DispatchKey("csr", "cuda"),) * 3
    with pytest.raises(ValueError, match="one format choice per part"):
        _per_part_keys(["csr", "dia"], 4)
    with pytest.raises(ValueError, match="do not stack"):
        DistributedOperator.build(M.fdm27(4, 4, 4), MESH4, local="sell")
    assert STACKABLE_FORMATS == ("coo", "csr", "dia", "ell")
    assert DISTRIBUTED_CANDIDATES == tuple(DispatchKey(f, "plain")
                                           for f in ("csr", "dia", "ell", "coo"))


def test_dispatched_keys_beside_choices():
    """A part carries no plan: csr/cuda runs csr/plain, and coo/cuda runs
    plain past ``max_onehot_rows``; ``describe(dispatched=True)`` says so
    where the plain ``describe`` keeps the reference's string."""
    s = M.fdm27(8, 8, 8)  # 128 rows a part
    cuda = lambda f: DispatchKey(f, "cuda")  # noqa: E731
    op = DistributedOperator.build(s, MESH4, local=("csr", "cuda"), remote=("coo", "cuda"))
    assert op.dispatched() == ((DispatchKey("csr", "plain"), cuda("coo")),) * 4
    assert op.describe() == " ".join(f"p{p}:csr/cuda+coo/cuda" for p in range(4))
    assert op.describe(dispatched=True) == " ".join(
        f"p{p}:csr/cuda->csr/plain+coo/cuda" for p in range(4))
    narrow = op.with_policy(ExecutionPolicy(max_onehot_rows=64))
    assert narrow.dispatched() == ((DispatchKey("csr", "plain"),
                                    DispatchKey("coo", "plain")),) * 4
    mixed = DistributedOperator.build(s, MESH4, local=[("dia", "cuda"), "ell", "dia", "coo"],
                                      remote=("dia", "cuda"))
    assert mixed.dispatched() == tuple((k, cuda("dia")) for k in (
        cuda("dia"), DispatchKey("ell", "plain"), DispatchKey("dia", "plain"),
        DispatchKey("coo", "plain")))
    assert mixed.describe(dispatched=True) == mixed.describe()
    rows = DistributedOperator.build(s, MESH4, local="csr", mode="rowblock")
    assert rows.dispatched() == ((DispatchKey("csr", "plain"), None),) * 4
    assert rows.describe(dispatched=True) == rows.describe() == " ".join(
        f"p{p}:csr/plain" for p in range(4))


def test_operator_refuses_vectors_off_its_home_device():
    s = M.fdm27(4, 4, 8)
    op = distribute(s, MESH4, local="dia", remote="coo")
    x = torch.ones(128, device="meta")
    with pytest.raises(ValueError, match="home device"):
        op @ x
    with pytest.raises(ValueError, match="home device"):
        op.masked_matvec(op.device_put(np.ones(128)), torch.ones(128, dtype=torch.bool,
                                                                  device="meta"))
    with pytest.raises(ValueError, match="only SpMV"):
        op @ torch.ones((128, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        op @ torch.ones(64)
    assert op.device_put(np.ones(128, np.float64)).dtype is torch.float32
    assert [tuple(r[1:]) for r in op.sharding()] == [(0, 32), (32, 64), (64, 96), (96, 128)]


def test_rowblock_operator_refuses_tune():
    op = DistributedOperator.build(M.banded(8, 1, seed=0), PartMesh.on("cpu", parts=1),
                                   local="csr", mode="rowblock")
    with pytest.raises(ValueError, match="rowblock"):
        op.tune()


def test_distributed_symgs_reference_schedule_rejected():
    sm = TS.SymGS.build(M.banded(8, 1, seed=0), method="reference", device="cpu")
    with pytest.raises(ValueError, match="multicolor"):
        sm.distribute(None)


# -------------------------------- the operator against the reference, 4 parts ----

#: The reference's 4-part cases (tests/test_distributed_spmv.py): (local,
#: remote, mode).
CASES = [
    ("dia", "coo", "auto"),
    ("csr", "csr", "allgather"),
    ("ell", "coo", "halo"),
    ("csr", None, "rowblock"),
    ([("dia", "plain"), ("csr", "plain"), ("ell", "plain"), ("coo", "plain")],
     "coo", "auto"),
]

_REFERENCE_4WAY = """
import json
import jax, numpy as np, jax.numpy as jnp
import scipy.sparse as sp
from jax.sharding import Mesh
from repro.core import matrices as M
from repro.core.distributed import DistributedSpMV
from repro.distributed_op import DistributedOperator, distribute

mesh = Mesh(np.array(jax.devices()).reshape(4), ("data",))
s = M.fdm27(4, 4, 8)
x = np.random.default_rng(0).standard_normal(128).astype(np.float32)
out, meta = {}, []
for i, (lf, rf, mode) in enumerate(CASES_JSON):
    lf = [tuple(k) for k in lf] if isinstance(lf, list) else lf
    kw = dict(local=lf, mode=mode)
    if rf is not None:
        kw["remote"] = rf
    op = DistributedOperator.build(s, mesh, "data", **kw)
    out[f"y{i}"] = np.asarray(op @ op.device_put(x))
    meta.append(dict(describe=op.describe(), format=op.format, halo=op.halo,
                     nbytes=int(op.nbytes), mode=op.mode,
                     local=[[list(g.key), list(g.members)] for g in op.local_groups],
                     remote=[[list(g.key), list(g.members)] for g in op.remote_groups]))
mask = np.random.default_rng(1).random(128) < 0.5
op = distribute(s, mesh, local="dia", remote="coo", mode="auto")
out["ym"] = np.asarray(op.masked_matvec(op.device_put(x),
                                        jax.device_put(jnp.asarray(mask), op.sharding())))
f2c = M.coarsen_injection(4, 4, 8)
nc = len(f2c)
R = sp.csr_matrix((np.ones(nc), (np.arange(nc), f2c)), shape=(nc, 128))
Rop = DistributedOperator.build(R, mesh, "data", local="csr", mode="auto")
out["yR"] = np.asarray(Rop @ op.device_put(x))
meta.append(dict(R_remote_groups=len(Rop.remote_groups), R_nbytes=int(Rop.nbytes)))
legacy = DistributedSpMV.build(s, mesh, "data", "dia", "coo")
out["ylegacy"] = np.asarray(legacy(op.device_put(x)))
np.savez(OUT, **out)
open(OUT + ".json", "w").write(json.dumps(meta))
print("OK")
"""


@pytest.fixture(scope="module")
def reference_4way(tmp_path_factory):
    """The reference's outputs on four fake host devices, for the cases
    above (one subprocess, so jax starts once)."""
    out = str(tmp_path_factory.mktemp("dist") / "ref.npz")
    code = (f"CASES_JSON = {json.dumps(CASES)!r}\nOUT = {out!r}\n"
            "import json as _j; CASES_JSON = _j.loads(CASES_JSON)\n" + _REFERENCE_4WAY)
    assert "OK" in run_py(code, devices=4)
    with open(out + ".json") as f:
        meta = json.load(f)
    return dict(np.load(out)), meta


def _x128():
    return np.random.default_rng(0).standard_normal(128).astype(np.float32)


def _oracle_err(y, want):
    return float(np.abs(np.asarray(y, np.float64) - want).max() / np.abs(want).max())


def _groups(groups):
    return [[list(g.key), list(g.members)] for g in groups]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_operator_cases_match_reference(reference_4way, i):
    out, meta = reference_4way
    lf, rf, mode = CASES[i]
    s = M.fdm27(4, 4, 8)
    x = _x128()
    kw = dict(local=tuple(lf) if isinstance(lf, list) else lf, mode=mode)
    if rf is not None:
        kw["remote"] = rf
    op = DistributedOperator.build(s, MESH4, "data", **kw)
    y = (op @ op.device_put(x)).numpy()
    want = s.toarray().astype(np.float32) @ x
    assert _oracle_err(y, want) < 1e-5
    assert _oracle_err(out[f"y{i}"], want) < 1e-5
    assert np.abs(y - out[f"y{i}"]).max() <= 1e-5 * np.abs(out[f"y{i}"]).max()
    m = meta[i]
    assert (op.describe(), op.format, op.halo, op.nbytes, op.mode) == (
        m["describe"].replace("pallas", "cuda"), m["format"], m["halo"], m["nbytes"],
        m["mode"])
    assert _groups(op.local_groups) == m["local"]
    assert _groups(op.remote_groups) == m["remote"]
    if mode in ("auto", "halo"):
        assert op.halo is not None  # the neighbour exchange ran
    if i == len(CASES) - 1:
        assert len(op.local_groups) == 4, op.describe()


def test_masked_rectangular_and_legacy_match_reference(reference_4way):
    out, meta = reference_4way
    s = M.fdm27(4, 4, 8)
    x = _x128()
    ref = s.toarray().astype(np.float32) @ x
    mask = np.random.default_rng(1).random(128) < 0.5
    op = distribute(s, MESH4, local="dia", remote="coo", mode="auto")
    ym = op.masked_matvec(op.device_put(x), torch.from_numpy(mask)).numpy()
    assert np.abs(ym - np.where(mask, ref, 0)).max() < 1e-4
    assert np.abs(ym - out["ym"]).max() <= 1e-5 * np.abs(out["ym"]).max()
    # masked rows are exactly the unmasked operator's rows
    np.testing.assert_array_equal(ym, np.where(mask, (op @ op.device_put(x)).numpy(), 0))

    R, _ = _rect(4, 4, 8)
    Rop = DistributedOperator.build(R, MESH4, "data", local="csr", mode="auto")
    assert not Rop.remote_groups and meta[-1]["R_remote_groups"] == 0
    assert Rop.nbytes == meta[-1]["R_nbytes"]
    yR = (Rop @ op.device_put(x)).numpy()
    np.testing.assert_allclose(yR, R @ x, rtol=1e-5)
    np.testing.assert_allclose(yR, out["yR"], rtol=1e-5)

    legacy = TD.DistributedSpMV.build(s, MESH4, "data", "dia", "coo")
    yl = legacy(op.device_put(x)).numpy()
    assert _oracle_err(yl, ref) < 1e-5
    assert np.abs(yl - out["ylegacy"]).max() <= 1e-5 * np.abs(out["ylegacy"]).max()


def test_rowblock_csr_plain_bitwise_equal_serial():
    for grid in [(4, 4, 8), (8, 8, 8), (16, 16, 16)]:
        s = M.fdm27(*grid)
        x = np.random.default_rng(3).standard_normal(s.shape[0]).astype(np.float32)
        serial = t_as_operator(s, "csr", device="cpu").using("plain")
        chk = DistributedOperator.build(s, MESH4, "data", local="csr", mode="rowblock")
        assert torch.equal(serial @ torch.from_numpy(x), chk @ chk.device_put(x)), grid


def test_tune_partitions_one_choice_per_part():
    s = M.fdm27(4, 4, 8)
    x = _x128()
    cand = list(DISTRIBUTED_CANDIDATES) + [("dia", "cuda"), ("ell", "cuda"),
                                           ("sell", "plain")]
    opt, table = tune_partitions(s, MESH4, candidates=cand)
    assert len(opt.choices) == 4
    assert all((p, "local") in table for p in range(4))
    assert all(k[0] != "sell" for tbl in table.values() for k in tbl)
    want = s.toarray().astype(np.float32) @ x
    assert _oracle_err((opt @ opt.device_put(x)).numpy(), want) < 1e-5
    with pytest.raises(ValueError, match="no stackable candidate"):
        tune_partitions(s, MESH4, candidates=[("sell", "plain")])


def test_autotune_distributed_picks_a_pair():
    s = M.fdm27(4, 4, 8)
    best, table = TD.autotune_distributed(s, MESH4, iters=2,
                                          candidates=(("dia", "coo"), ("csr", "csr"),
                                                      ("sell", "coo")))
    assert table[("sell", "coo")].startswith("build failed")
    assert isinstance(table[("dia", "coo")], float)
    x = _x128()
    want = s.toarray().astype(np.float32) @ x
    assert _oracle_err(best(torch.from_numpy(x)).numpy(), want) < 1e-5


def test_distributed_symgs_matches_serial_sweep():
    """One distributed multicolor SymGS sweep equals the port's serial one."""
    s = M.fdm27(4, 4, 4)
    n = s.shape[0]
    r = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    sm = TS.SymGS.build(s, method="multicolor", device="cpu")
    y1 = sm(torch.from_numpy(r))
    for local, remote in [("csr", "csr"), ("dia", "coo"), (("ell", "cuda"), ("coo", "cuda"))]:
        op = DistributedOperator.build(s, MESH4, "data", local=local, remote=remote)
        yd = sm.distribute(op)(op.device_put(r))
        assert float((yd - y1).abs().max()) < 1e-5, (local, remote)


def test_distribute_vcycle_levels_and_transfers():
    vc = TS.build_mg(8, 8, 8, depth=TS.distributable_depth(8, 8, 8, 4), device="cpu")
    dv = TS.distribute_vcycle(vc, MESH4)
    assert dv.depth == vc.depth == 3
    for lvl in dv.levels:
        assert isinstance(lvl.A, DistributedOperator) and lvl.smoother.A is lvl.A
    fine = dv.levels[0]  # whole z-planes a part: the injection needs no exchange
    assert not fine.R.remote_groups and not fine.P.remote_groups
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(512).astype(np.float32))
    assert float((dv(r) - vc(r)).abs().max()) <= 1e-5 * float(vc(r).abs().max())
    with pytest.raises(ValueError, match="divisible"):
        TS.distribute_vcycle(TS.build_mg(6, 6, 6, depth=2, device="cpu"), MESH4)


# ------------------------------------------------------------- HPCG 16^3 ----


@pytest.fixture(scope="module")
def jax_pcg_16():
    """The reference PCG at 16^3: build_mg + cg on csr/plain (jitted)."""
    import jax

    from repro.core import as_operator as j_as_operator

    s = M.fdm27(16, 16, 16)
    b = jnp.asarray(s @ np.ones(s.shape[0]), jnp.float32)
    A = j_as_operator(s, "csr").using("plain")
    mg = JS.build_mg(16, 16, 16, depth=4)
    info = jax.jit(lambda b: JS.cg(lambda p: A @ p, b, tol=1e-6, maxiter=50,
                                   precond=mg))(b)
    return np.asarray(info.x), int(info.iters)


def test_run_hpcg_distributed_16cubed_acceptance(jax_pcg_16):
    """The reference's acceptance run on four CPU parts: bitwise, valid,
    converged within 25 iterations, and the solution within a relative
    2-norm of 1e-4 of the reference's serial 16^3 PCG."""
    res = run_hpcg_distributed(MESH4, 16, 16, 16, iters=50, tol=1e-6, timed=False,
                               verbose=False, graph=False)
    assert res.bitwise, "distributed csr/plain SpMV != single-device (bitwise)"
    assert res.rel_res <= 1e-6 and res.valid, (res.rel_err, res.rel_res)
    assert res.pcg_iters <= 25
    assert len(res.mg_levels.split("|")) == 4
    assert set(res.table) >= {f"p{p}/local" for p in range(4)}


def test_run_hpcg_distributed_solution_matches_reference(jax_pcg_16, monkeypatch):
    """The tuned distributed solve's x against the reference's serial PCG."""
    import repro_torch.apps.hpcg as thpcg

    got = {}
    orig = thpcg.cg

    def recording(*a, **kw):
        info = orig(*a, **kw)
        got.setdefault("x", []).append(info.x)
        return info

    monkeypatch.setattr(thpcg, "cg", recording)
    res = run_hpcg_distributed(MESH4, 16, 16, 16, iters=50, timed=True, reps=1,
                               verbose=False, tune_levels=True, graph=False,
                               candidates=[("csr", "plain"), ("dia", "cuda"),
                                           ("ell", "cuda"), ("coo", "cuda")])
    assert res.valid and res.bitwise and res.ref_time_s > 0 and res.opt_time_s > 0
    x_dist = got["x"][-1].numpy()  # the tuned distributed convergence run
    x_jax, _ = jax_pcg_16
    rel = np.linalg.norm(x_dist.astype(np.float64) - x_jax) / np.linalg.norm(x_jax)
    assert rel <= 1e-4
    assert "dist(" in res.mg_levels
