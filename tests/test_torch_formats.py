"""The port's containers, plans, generators and features against the JAX
reference: every array equal, dtype included, on the same scipy input.

Host-side numpy code must agree exactly (ROADMAP, "held against the
reference"), so these tests compare with ``array_equal`` — bf16 values by
their bit patterns.
"""
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matrices as JM
from repro_torch.core import matrices as TM

# the packages re-export a ``convert`` function over the module of that name
jat = importlib.import_module("repro.core.autotune")
jconv = importlib.import_module("repro.core.convert")
jfeat = importlib.import_module("repro.core.features")
tat = importlib.import_module("repro_torch.core.autotune")
tconv = importlib.import_module("repro_torch.core.convert")
tfeat = importlib.import_module("repro_torch.core.features")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIELDS = {
    "coo": ("row", "col", "val"), "csr": ("indptr", "indices", "data"),
    "dia": ("offsets", "data"), "ell": ("indices", "data"),
    "sell": ("sptr", "indices", "data", "perm"), "bsr": ("bcols", "blocks"),
    "dense": ("data",),
}


def _matrices():
    mats = dict(JM.suite("small"))
    mats["fdm27_8x8x8"] = JM.fdm27(8, 8, 8)
    mats["fdm27_16x16x16"] = JM.fdm27(16, 16, 16)
    return mats


MATS = _matrices()


def _np_of_torch(t: torch.Tensor) -> np.ndarray:
    if t.dtype is torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_of_jax(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_array(t: torch.Tensor, a, what: str):
    a = np.asarray(a)
    assert str(t.dtype).replace("torch.", "") == a.dtype.name, (what, t.dtype, a.dtype)
    assert tuple(t.shape) == a.shape, (what, tuple(t.shape), a.shape)
    np.testing.assert_array_equal(_np_of_torch(t), _np_of_jax(a), err_msg=what)


def assert_same_container(T, J, what: str):
    assert T.format == J.format and tuple(T.shape) == tuple(J.shape), what
    for f in FIELDS[T.format]:
        assert_same_array(getattr(T, f), getattr(J, f), f"{what}.{f}")
    if T.format == "dia":
        assert T.extent == J.extent, what
    if T.format == "sell":
        assert T.C == J.C, what
    tp, jp = getattr(T, "plan", None), getattr(J, "plan", None)
    assert (tp is None) == (jp is None), f"{what}: plan presence"
    if tp is not None:
        assert tp.kind == jp.kind and tuple(tp.meta) == tuple(int(m) for m in jp.meta), what
        for i, (ta, ja) in enumerate(zip(tp.arrays, jp.arrays)):
            assert_same_array(ta, ja, f"{what}.plan[{i}]")


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia", "ell", "sell", "bsr", "dense"])
def test_containers_equal_reference(fmt):
    """Default builds (auto plans) over the small suite and fdm27 8^3/16^3."""
    for name, s in MATS.items():
        if fmt == "dense" and s.shape[0] > 1000:
            continue
        J = jconv.from_dense(s, fmt)
        T = tconv.from_dense(s, fmt, device="cpu")
        assert_same_container(T, J, f"{name}/{fmt}")


@pytest.mark.parametrize("fmt,col_tile", [("csr", 16), ("sell", 24), ("dia", 16),
                                          ("ell", 32), ("coo", 16), ("csr", 4096)])
def test_forced_plans_equal_reference(fmt, col_tile):
    """Column-tiled plans (scs, dia-cols, ell-cols, coo-cols) forced with a
    small tile, so every plan kind and int8/int16 indices are covered."""
    for name, s in MATS.items():
        if col_tile > s.shape[1] and col_tile != 4096:
            continue
        J = jconv.from_dense(s, fmt, col_tile=col_tile)
        T = tconv.from_dense(s, fmt, col_tile=col_tile, device="cpu")
        assert_same_container(T, J, f"{name}/{fmt}/ct={col_tile}")


@pytest.mark.parametrize("fmt,dtype", [("csr", "bfloat16"), ("dia", "bfloat16"),
                                       ("sell", "float16"), ("ell", "float16"),
                                       ("coo", "bfloat16"), ("bsr", "float16")])
def test_narrow_value_storage_equal_reference(fmt, dtype):
    """bf16/f16 value arrays (and their plans) hold the reference's bits."""
    s = MATS["banded_b3_n200_s0"] + MATS["random_d05_n200_s0"]
    kw = {"col_tile": 64} if fmt != "bsr" else {}
    J = jconv.from_dense(s, fmt, dtype=jnp.dtype(dtype), **kw)
    T = tconv.from_dense(s, fmt, dtype=dtype, device="cpu", **kw)
    assert_same_container(T, J, f"{fmt}/{dtype}")


@pytest.mark.parametrize("index_dtype", ["int8", "int16", "int32"])
def test_pinned_index_dtype_equal_reference(index_dtype):
    s = MATS["powerlaw_n200_s0"]
    for fmt in ("csr", "sell", "ell", "coo"):
        J = jconv.from_dense(s, fmt, col_tile=64, index_dtype=index_dtype)
        T = tconv.from_dense(s, fmt, col_tile=64, index_dtype=index_dtype, device="cpu")
        assert_same_container(T, J, f"{fmt}/{index_dtype}")


def test_generators_equal_reference():
    for (jn, js), (tn, ts) in zip(JM.suite("small"), TM.suite("small")):
        assert jn == tn
        assert (js != ts).nnz == 0 and js.dtype == ts.dtype, jn
    assert TM.suite_names("bench") == JM.suite_names("bench")
    for grid in [(4, 4, 4), (6, 4, 8), (16, 16, 16)]:
        assert (JM.fdm27(*grid) != TM.fdm27(*grid)).nnz == 0
        np.testing.assert_array_equal(TM.coarsen_injection(*grid),
                                      JM.coarsen_injection(*grid))


def test_from_reference_round_trips():
    """A reference container's numpy arrays (bf16 included) rebuild the same
    container in the port, plan and all."""
    s = MATS["banded_b9_n200_s0"]
    for fmt, dtype, kw in [("csr", "float32", {"col_tile": 32}),
                           ("dia", "bfloat16", {"col_tile": 64}),
                           ("sell", "float16", {}), ("ell", "float32", {}),
                           ("coo", "float32", {}), ("bsr", "float32", {})]:
        J = jconv.from_dense(s, fmt, dtype=jnp.dtype(dtype), **kw)
        arrays = {f: np.asarray(getattr(J, f)) for f in FIELDS[fmt]}
        jp = getattr(J, "plan", None)
        plan = None if jp is None else (jp.kind, [np.asarray(a) for a in jp.arrays], jp.meta)
        aux = {"extent": J.extent} if fmt == "dia" else {"C": J.C} if fmt == "sell" else {}
        T = tconv.from_reference(fmt, arrays, J.shape, plan, device="cpu", **aux)
        assert_same_container(T, J, f"from_reference {fmt}")
        np.testing.assert_array_equal(
            T.to_dense().float().numpy(), np.asarray(J.to_dense(), np.float32))


def test_features_and_structural_skip_equal_reference():
    for name, s in MATS.items():
        jf = jfeat.extract_features(s).asdict()
        assert tfeat.extract_features(s).asdict() == jf, name
        # from port containers too: their padding schemes are undone the same way
        for fmt in ("coo", "dia", "sell"):
            T = tconv.from_dense(s, fmt, device="cpu")
            assert tfeat.extract_features(T).asdict() == jf, (name, fmt)
        for fmt in ("coo", "csr", "dia", "ell", "sell", "bsr"):
            assert tat.structural_skip(s, fmt) == jat.structural_skip(s, fmt), (name, fmt)


def test_package_imports_neither_jax_nor_repro():
    """The port imports without ``jax`` and without the reference package:
    both are blocked in ``sys.modules`` of a fresh interpreter."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.kernels._build, repro_torch.kernels.ref\n"
        "import repro_torch.solvers, repro_torch.apps.hpcg\n"
        "from repro_torch.core.spmv import available_impls\n"
        "assert 'cuda' in available_impls('csr')\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tconv.from_dense(MATS["tridiag_n64_s0"], "csr")
