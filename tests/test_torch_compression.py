"""The int8 compressed all-reduce with error feedback
(``repro_torch.distributed.compression``) on ``PartMesh.on("cpu",
parts=4)``, against the reference's ``shard_map`` over four fake host
devices (one ``run_py(code, devices=4)`` subprocess, ~5 s, handing its
arrays over in an ``.npz``): at the reference test's n 2048 / chunk 64 and
at n 5000 / chunk 256, two calls each (the second fed the first's
residual). The int8 codes each part sends equal the reference's (0 of them
differ), and the mean and the residual agree within one quantisation step
(measured: equal bits). Also the twin of the reference's
``test_compressed_allreduce_4way`` and its chunk quirk."""
import numpy as np
import pytest
import torch

from conftest import run_py
from repro_torch.core import PartMesh
from repro_torch.distributed.compression import (CompressedAllReduce, _dequant, _quant,
                                                 int8_psum_mean)

CASES = ((2048, 64), (5000, 256))

REF_CODE = r"""
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.compression import CompressedAllReduce, _quant
mesh = Mesh(np.array(jax.devices()).reshape(4), ("data",))
out = {}
for n, chunk in CASES:
    car = CompressedAllReduce(mesh, "data", chunk=chunk)
    npad = car.padded_len(n)
    vecs = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    vp = np.zeros((4, npad), np.float32); vp[:, :n] = vecs
    m1, e1 = car(jnp.asarray(vp), car.init_error(n))
    m2, e2 = car(jnp.asarray(vp), e1)
    v2 = jnp.asarray(vp) + e1
    out[f"{n}_m1"], out[f"{n}_e1"] = np.asarray(m1), np.asarray(e1)
    out[f"{n}_m2"], out[f"{n}_e2"] = np.asarray(m2), np.asarray(e2)
    for p in range(4):
        for c in (256, chunk):
            q, s = _quant(v2[p], c)
            out[f"{n}_q{p}_{c}"], out[f"{n}_s{p}_{c}"] = np.asarray(q), np.asarray(s)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("compression") / "ref.npz"
    run_py(f"CASES = {CASES!r}\nOUT = {str(path)!r}\n" + REF_CODE, devices=4)
    return dict(np.load(path))


def _vectors(n, car):
    npad = car.padded_len(n)
    vecs = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    vp = np.zeros((4, npad), np.float32)
    vp[:, :n] = vecs
    return vecs, torch.from_numpy(vp)


@pytest.mark.parametrize("n,chunk", CASES)
def test_against_reference(ref, n, chunk):
    car = CompressedAllReduce(PartMesh.on("cpu", parts=4), chunk=chunk)
    _, vp = _vectors(n, car)
    m1, e1 = car(vp, car.init_error(n))
    m2, e2 = car(vp, e1)
    v2 = vp + e1
    differing = 0
    for p in range(4):
        for c in (256, chunk):
            q, s = _quant(v2[p], c)
            differing += int((q.numpy() != ref[f"{n}_q{p}_{c}"]).sum())
            np.testing.assert_array_equal(s.numpy(), ref[f"{n}_s{p}_{c}"])
    assert differing == 0
    for got, key in ((m1, "m1"), (e1, "e1"), (m2, "m2"), (e2, "e2")):
        want = ref[f"{n}_{key}"]
        step = np.abs(want).max() / 127 if key.startswith("m") else \
            float(v2.abs().max()) / 127
        assert np.abs(got.numpy() - want).max() <= step, key
        np.testing.assert_array_equal(got.numpy(), want)  # measured: equal bits


def test_compressed_allreduce_4way():
    """Twin of the reference's ``test_compressed_allreduce_4way``."""
    car = CompressedAllReduce(PartMesh.on("cpu", parts=4), "data", chunk=64)
    rng = np.random.default_rng(0)
    n = 2048
    npad = car.padded_len(n)
    vecs = rng.standard_normal((4, n)).astype(np.float32)
    vp = np.zeros((4, npad), np.float32)
    vp[:, :n] = vecs
    mean, err = car(torch.from_numpy(vp), car.init_error(n))
    rel = np.abs(mean.numpy()[:n] - vecs.mean(0)).max() / np.abs(vecs.mean(0)).max()
    assert rel < 0.05, rel
    e = err.numpy()[:, :n]
    assert 0 < np.abs(e).max() < 0.05


def test_rows_are_the_parts_and_repeat_their_bits():
    mesh = PartMesh.on("cpu", parts=4)
    car = CompressedAllReduce(mesh, chunk=256)
    _, vp = _vectors(4096, car)
    red = int8_psum_mean(vp, mesh)
    assert red.shape == vp.shape and bool((red == red[0]).all())
    a, b = car(vp, car.init_error(4096)), car(vp, car.init_error(4096))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert car.init_error(4096).device == mesh.home


def test_chunk_quirk_of_the_reference():
    """As in the reference, the wire quantises at 256 whatever ``chunk``
    says, while the residual is taken at ``chunk``: at chunk 64 the
    residual is not what the wire lost."""
    car = CompressedAllReduce(PartMesh.on("cpu", parts=4), chunk=64)
    _, vp = _vectors(2048, car)
    _, err = car(vp, car.init_error(2048))
    q, s = _quant(vp[0], 256)
    lost_on_wire = vp[0] - _dequant(q, s, vp.shape[1])
    assert not torch.equal(err[0], lost_on_wire)
    q, s = _quant(vp[0], 64)
    assert torch.equal(err[0], vp[0] - _dequant(q, s, vp.shape[1]))
    # n_pad / DP must be a multiple of 256: 256 / 4 = 64 is not
    small = CompressedAllReduce(PartMesh.on("cpu", parts=4), chunk=64)
    with pytest.raises(RuntimeError):
        small(torch.ones(4, small.padded_len(200)), small.init_error(200))


def test_quant_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 0.0, 0.0])
    q, s = _quant(x, chunk=8)
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 0, 0]]
