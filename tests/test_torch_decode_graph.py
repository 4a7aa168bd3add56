"""The decode step with its position on the device, the host's side of the
captured decode step (``repro_torch.serve.CapturedDecode``), the port's
form of the reference's ``jax.jit(decode_step, donate_argnums=(2,))``.

Smoke-size models of every family (llama3.2-1b; qwen3-moe on each of the
five MoE lanes; deepseek-v2 and jamba on the ``bsr`` lane; rwkv6;
whisper), seeded, on the CPU:

  - a 0-dim tensor position gives the int position's logits and caches bit
    for bit, over a prompt and a few greedy steps;
  - on the reference's weights (``params_from_reference``, f32) the
    tensor-position step agrees with the reference's jitted, donated
    ``decode_step`` at ``tests/test_torch_models_lm.py``'s f32 tolerance
    (``rtol=1e-4``, atol ``1e-5 * max|logit|``);
  - the tensor-position step reads nothing from the device: under a
    ``TorchDispatchMode`` that fails on ``aten._local_scalar_dense``,
    ``nonzero`` and ``unique``, the host's proxy for "a capture will not
    raise". It runs under the plain policy for every lane, and under the
    ``cuda`` policy for every lane but ``coo``: on host tensors the
    ``cuda`` policy runs each kernel's plain version, and the COO kernel's
    loops over the longest row, a bound it reads, on a branch the card
    never takes (the card sorts and launches, ``kernels/coo_spmv.py``);
  - ``CapturedDecode`` and ``serve_lm(graph=True)`` raise on a host device;
  - ``reset_caches`` zeroes every leaf in place.

The captured step itself runs only on the card
(``tests/test_torch_decode_graph_cuda.py``, ``-m cuda``).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jget_smoke
from repro.core import use_backend as juse_backend
from repro.models import build_model as jbuild

from repro_torch.configs import get_smoke_config
from repro_torch.core import SparseOperator, use_backend
from repro_torch.core.formats import COO
from repro_torch.kernels import coo_spmv as kcoo
from repro_torch.models import build_model, params_from_reference, reset_caches
from repro_torch.models import moe as tmoe
from repro_torch.models.model import cache_positions
from repro_torch.serve import CapturedDecode
from repro_torch.tree import leaves

LANES = ("bsr", "sort", "onehot", "grouped", "coo")
#: (arch, MoE lane) of every family the smoke or the tests serve
FAMILIES = ([("llama3.2-1b", None)] + [("qwen3-moe-235b-a22b", lane) for lane in LANES]
            + [("deepseek-v2-236b", "bsr"), ("jamba-v0.1-52b", "bsr"), ("rwkv6-7b", None),
               ("whisper-base", None)])
IDS = [f"{a}-{lane}" if lane else a for a, lane in FAMILIES]
B, S, G = 2, 4, 3
#: the host reads a capture does not take
READS = {"_local_scalar_dense", "nonzero", "unique", "_unique", "_unique2", "unique_dim",
         "unique_consecutive"}


def _cfg(get, arch, lane, dtype=None):
    cfg = get(arch)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    if lane and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_impl=lane))
    return cfg


def _model(arch, lane, dtype=None):
    model = build_model(_cfg(get_smoke_config, arch, lane, dtype), device="cpu")
    return model, model.init(0)


def _prompt(vocab):
    return np.random.default_rng(5).integers(1, vocab, (B, S)).astype(np.int32)


class _NoHostRead(TorchDispatchMode):
    """Fails on every operation that hands a device value to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in READS:
            raise AssertionError(f"the decode step read the device: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,lane", FAMILIES, ids=IDS)
def test_tensor_position_gives_the_int_positions_bits(arch, lane):
    """The served config's dtype (bf16 activations) on the serving policy:
    every step's logits and, at the end, every cache leaf equal bit for
    bit between an int position and a 0-dim int64 tensor one."""
    model, params = _model(arch, lane)
    prompt = torch.from_numpy(_prompt(model.cfg.vocab))
    ca, cb = model.init_caches(B, S + G), model.init_caches(B, S + G)
    tok = prompt[:, :1]
    with use_backend("cuda"), torch.no_grad():
        for t in range(S + G):
            la, _ = model.decode_step(params, tok, ca, t)
            lb, _ = model.decode_step(params, tok, cb, torch.tensor(t))
            assert torch.equal(la, lb), t
            tok = prompt[:, t + 1:t + 2] if t + 1 < S else la.argmax(-1).to(torch.int32)[:, None]
    for a, b in zip(leaves(ca), leaves(cb)):
        assert torch.equal(a, b)
    assert any(bool(a.abs().max() > 0) for a in leaves(ca))


@pytest.mark.parametrize("arch,lane", FAMILIES, ids=IDS)
def test_tensor_position_against_the_reference_jitted_donated_step(arch, lane):
    """Weights carried across: the port's tensor-position step against the
    reference's ``jax.jit(decode_step, donate_argnums=(2,))`` (what
    ``repro.launch.serve`` runs), both fed the same tokens (the prompt,
    then the reference's greedy tokens), in f32."""
    jm = jbuild(_cfg(jget_smoke, arch, lane, "float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = _cfg(get_smoke_config, arch, lane, "float32")
    tm = build_model(cfg, device="cpu")
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    prompt = _prompt(cfg.vocab)
    decode = jax.jit(jm.decode_step, donate_argnums=(2,))
    jc, tc = jm.init_caches(B, S + G), tm.init_caches(B, S + G)
    tok = prompt[:, :1]
    for t in range(S + G):
        with juse_backend("plain"):
            want, jc = decode(jp, jnp.asarray(tok), jc, t)
        want = np.asarray(want, np.float32)
        with use_backend("cuda"), torch.no_grad():
            got, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))
        tok = prompt[:, t + 1:t + 2] if t + 1 < S else want.argmax(-1).astype(np.int32)[:, None]


#: every family and lane under both policies, but coo under ``cuda``: the
#: card's coo branch is not the host's (module docstring)
NO_READ = [(a, lane, policy) for a, lane in FAMILIES for policy in ("plain", "cuda")
           if not (lane == "coo" and policy == "cuda")]


@pytest.mark.parametrize("arch,lane,policy", NO_READ,
                         ids=["-".join(filter(None, case)) for case in NO_READ])
def test_tensor_position_step_reads_nothing_from_the_device(arch, lane, policy):
    """One eager step first (the warm-up of a capture: first-call caches),
    then a step at a tensor position under ``_NoHostRead``."""
    model, params = _model(arch, lane)
    caches = model.init_caches(B, S)
    tok = torch.from_numpy(_prompt(model.cfg.vocab)[:, :1])
    pos = torch.zeros((), dtype=torch.int64)
    with use_backend(policy), torch.no_grad():
        model.decode_step(params, tok, caches, pos)
        pos.fill_(1)
        with _NoHostRead():
            logits, _ = model.decode_step(params, tok, caches, pos)
    assert logits.shape == (B, model.cfg.vocab) and bool(torch.isfinite(logits).all())


def test_no_host_read_mode_catches_a_read():
    """The mode fails on an int position's sibling that reads: indexing a
    cache with a tensor position goes through ``.item()``."""
    cache = torch.zeros((2, 4, 3))
    with pytest.raises(AssertionError, match="read the device"), _NoHostRead():
        cache[:, torch.tensor(1)] = torch.ones((2, 3))


def test_coo_lane_marks_its_containers_and_keeps_the_bits():
    """The MoE ``coo`` lane's dispatch and combine come marked
    ``UNSORTED``: their plain products take the stable row sort without
    reading the order, and give the unmarked container's bits; the kernel
    wrapper's order check is skipped for them."""
    T, E, K, C, D = 16, 4, 2, 6, 8
    rng = np.random.default_rng(3)
    tope = torch.from_numpy(np.stack([rng.permutation(E)[:K] for _ in range(T)]))
    topw = torch.from_numpy(rng.random((T, K)).astype(np.float32))
    slot, t_s, w_s, keep = tmoe._dispatch_indices(tope, topw, T, E, K, C)
    assert not bool(keep.all())                                # some drops: rows go down
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((E * C + 1, D)).astype(np.float32))
    for P, X in ((tmoe.coo_dispatch(slot, t_s, keep, T, E, C, torch.float32), x),
                 (tmoe.coo_combine(slot, t_s, w_s, keep, T, E, C, torch.float32), h)):
        assert P.cache.get(kcoo.UNSORTED) is True
        bare = COO(P.row, P.col, P.val, P.shape)
        with use_backend("plain"):
            got = SparseOperator(bare) @ X
            with _NoHostRead():
                marked = SparseOperator(P) @ X
        assert torch.equal(marked, got)
    row = torch.tensor([2, 0, 1, 1, 0], dtype=torch.int32)
    col, val = torch.arange(5, dtype=torch.int32), torch.arange(5.0)
    checked, unchecked = kcoo.row_sorted(row, col, val), kcoo.row_sorted(row, col, val, False)
    for a, b in zip(checked[:3], unchecked[:3]):
        assert torch.equal(a, b)
    srt = kcoo.row_sorted(*kcoo.row_sorted(row, col, val)[:3], check=False)
    assert srt[3] is not None and torch.equal(srt[3], torch.arange(5))


@pytest.mark.parametrize("arch,lane", FAMILIES, ids=IDS)
def test_reset_caches_zeroes_every_leaf_in_place(arch, lane):
    model, params = _model(arch, lane)
    caches = model.init_caches(B, S)
    ptrs = [t.data_ptr() for t in leaves(caches)]
    tok = torch.from_numpy(_prompt(model.cfg.vocab)[:, :1])
    with use_backend("cuda"), torch.no_grad():
        model.decode_step(params, tok, caches, torch.tensor(0))
    assert any(bool(t.abs().max() > 0) for t in leaves(caches))
    reset_caches(caches)
    assert [t.data_ptr() for t in leaves(caches)] == ptrs
    assert all(not bool(t.any()) for t in leaves(caches))
    want = None if model.cfg.rwkv else S
    assert cache_positions(caches) == want


def test_captured_decode_refuses_host_tensors():
    model, params = _model("llama3.2-1b", None)
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedDecode(model, params, model.init_caches(B, S), B)


@pytest.mark.parametrize("graph", [True, None])
def test_serve_lm_graph_refuses_a_host_device(graph):
    """``graph=True``, or no ``graph`` at all (the reference's compiled
    form by default), on ``--device cpu`` raises before any step and names
    ``--no-graph``; the CLI's default does the same."""
    from repro_torch.launch import serve as tserve

    args = types.SimpleNamespace(arch="llama3.2-1b", smoke=True, batch=B, prompt_len=S, gen=G,
                                 seed=0, layers=0, dispatch_impl=None, device="cpu")
    if graph is not None:
        args.graph = graph
    with pytest.raises(ValueError, match="--no-graph"):
        tserve.serve_lm(args)
    with pytest.raises(ValueError, match="--no-graph"):
        tserve.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "2", "--prompt-len", "2",
                     "--gen", "1", "--device", "cpu"])


def test_serve_lm_without_graph_reports_no_graph(capsys):
    from repro_torch.launch import serve as tserve

    tserve.main(["--arch", "jamba-v0.1-52b", "--smoke", "--batch", "2", "--prompt-len", "2",
                 "--gen", "2", "--device", "cpu", "--no-graph"])
    out = capsys.readouterr().out
    assert "sample continuation" in out and "decode graph" not in out
    args = types.SimpleNamespace(arch="rwkv6-7b", smoke=True, batch=B, prompt_len=S, gen=G,
                                 seed=0, layers=0, dispatch_impl=None, device="cpu", graph=False)
    assert tserve.serve_lm(args)["graph"] is None
