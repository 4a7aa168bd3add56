"""The int8 compressed all-reduce on the card: ``CompressedAllReduce`` over
``PartMesh.on("cuda", parts=4)`` (imports no JAX: the card's machine has
none). Two calls give equal bits, and the card's mean and residual agree
with the same call on host tensors within one quantisation step. The
card's int8 codes and chunk scales, and so its mean and residual, are
the host's bit for bit: ``_quant`` divides the absmax by a device tensor,
where a division by the Python scalar 127.0 multiplied by its reciprocal
on the card and gave other scales (``examples/int8_card_vs_host.py``).
Every test skips without a card."""
import numpy as np
import pytest
import torch

from repro_torch.core import PartMesh
from repro_torch.distributed.compression import CompressedAllReduce, _quant

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return PartMesh.on("cuda", parts=4)


@pytest.mark.parametrize("n,chunk", [(2048, 64), (1 << 20, 256)])
def test_card_against_host(card, n, chunk):
    vecs = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    host = CompressedAllReduce(PartMesh.on("cpu", parts=4), chunk=chunk)
    dev = CompressedAllReduce(card, chunk=chunk)
    vp = torch.zeros(4, host.padded_len(n))
    vp[:, :n] = torch.from_numpy(vecs)
    m_h, e_h = host(vp, host.init_error(n))
    m_d, e_d = dev(vp.cuda(), dev.init_error(n))
    assert m_d.device.type == "cuda" and e_d.device.type == "cuda"
    step_m = float(m_h.abs().max()) / 127
    step_e = float(vp.abs().max()) / 127
    assert float((m_d.cpu() - m_h).abs().max()) <= step_m
    assert float((e_d.cpu() - e_h).abs().max()) <= step_e
    m_d2, e_d2 = dev(vp.cuda(), dev.init_error(n))
    assert torch.equal(m_d, m_d2) and torch.equal(e_d, e_d2)


@pytest.mark.parametrize("n,chunk", [(2048, 64), (1 << 20, 256), (1 << 22, 256)])
def test_card_codes_and_scales_are_the_hosts(card, n, chunk):
    """And so the whole all-reduce's mean and residual are the host's."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    q_h, s_h = _quant(x, chunk)
    q_d, s_d = _quant(x.cuda(), chunk)
    assert torch.equal(s_d.cpu(), s_h)
    assert torch.equal(q_d.cpu(), q_h)
    vecs = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    host = CompressedAllReduce(PartMesh.on("cpu", parts=4), chunk=chunk)
    dev = CompressedAllReduce(card, chunk=chunk)
    vp = torch.zeros(4, host.padded_len(n))
    vp[:, :n] = torch.from_numpy(vecs)
    m_h, e_h = host(vp, host.init_error(n))
    m_d, e_d = dev(vp.cuda(), dev.init_error(n))
    assert torch.equal(m_d.cpu(), m_h) and torch.equal(e_d.cpu(), e_h)
