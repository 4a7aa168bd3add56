"""The port's configs, sharding rules, layers and attention
(``repro_torch.configs``, ``distributed/sharding.py``,
``models/layers.py``, ``models/attention.py``) against the reference on the
same numpy inputs; the MoE layer is held in ``test_torch_models_moe.py``,
the LM and its serving loop in ``test_torch_models_lm.py``.

Exact: configs field for field, parameter counts, the sharding rules'
axes and specs. f32 numbers: ``rtol=1e-4, atol=1e-5`` for the layers and
the attention primitives (the reference's own MoE contract,
``tests/test_moe.py``).
"""
import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import list_archs as jlist_archs
from repro.core import use_backend as juse_backend
from repro.distributed import sharding as jsharding
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models.model import count_params_struct as jcount

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import use_backend
from repro_torch.distributed import sharding
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, count_params_struct
from repro_torch.models import layers as tlayers

tcfg_base = importlib.import_module("repro_torch.configs.base")
jcfg_base = importlib.import_module("repro.configs.base")

ARCHS = sorted(jlist_archs())
#: The archs whose models the port builds: every one.
PORTED_FULL = ARCHS
F32 = dict(rtol=1e-4, atol=1e-5)


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _carried(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------------------ configs ----


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (type(v).__name__, _fields(v)) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_for_field(arch):
    assert list_archs() == ARCHS
    for want, got in ((jget_config(arch), get_config(arch)),
                      (jget_smoke(arch), get_smoke_config(arch))):
        assert type(got).__name__ == type(want).__name__
        assert _fields(got) == _fields(want)
        assert got.hd == want.hd and got.is_encdec == want.is_encdec
        assert str(got.activation_dtype).replace("torch.", "") == jnp.dtype(
            want.activation_dtype).name
    assert tcfg_base.SHAPES == tuple(tcfg_base.ShapeCell(*dataclasses.astuple(s))
                                     for s in jcfg_base.SHAPES)
    for s in jcfg_base.SHAPES:
        assert tcfg_base.cell_applicable(get_config(arch), tcfg_base.shape_by_name(s.name)) \
            == jcfg_base.cell_applicable(jget_config(arch), s)


@pytest.mark.parametrize("arch", PORTED_FULL)
def test_param_counts_equal(arch):
    cfg = get_config(arch)
    assert count_params_struct(cfg) == jcount(jget_config(arch))
    assert cfg.param_count() == jget_config(arch).param_count()
    assert cfg.active_param_count() == jget_config(arch).active_param_count()


# ----------------------------------------------------------------- sharding ----


MESHES = [{"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 16}, {"model": 8}]


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen1.5-4b", "internvl2-26b",
                                  "llama3.2-1b", "deepseek-v2-236b", "jamba-v0.1-52b",
                                  "rwkv6-7b", "whisper-base"])
def test_axes_and_specs_over_every_param_path(arch):
    """Every parameter path of the full config: the same logical axes, and
    the same spec on each mesh (the reference reads a mesh's axis sizes)."""
    shapes = jax.eval_shape(jbuild(jget_config(arch)).init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        p = jsharding._path_str(path)
        want[p] = (tuple(leaf.shape), jsharding.axes_for_path(p, len(leaf.shape)))
    got = {p: (tuple(t.shape), sharding.axes_for_path(p, t.dim()))
           for p, t in sharding.param_paths(build_model(get_config(arch), "meta").init())}
    assert got == want
    for sizes in MESHES:
        mesh = types.SimpleNamespace(shape=sizes)
        specs = sharding.params_pspecs(build_model(get_config(arch), "meta").init(), sizes)
        for p, (shape, axes) in want.items():
            assert specs[p] == tuple(jsharding.spec_for(shape, axes, mesh))
    assert sharding.PARAM_AXES_RULES == jsharding.PARAM_AXES_RULES
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


def test_sharding_context_and_constraint():
    x = torch.ones(4, 6)
    assert sharding.current_mesh() is None
    assert sharding.spec_for((4, 6), ("batch", "vocab")) == ()
    with sharding.sharding_context({"data": 2, "model": 3}, rules={"vocab": ("model",)}):
        assert sharding.current_mesh() == {"data": 2, "model": 3}
        assert sharding.spec_for((4, 6), ("batch", "vocab")) == (("data",), "model")
        assert sharding.logical_constraint(x, ("batch", None)) is x
    assert sharding.current_mesh() is None
    assert sharding.logical_constraint(x, ("batch", None)) is x


# ----------------------------------------------------------- layers, attention ----


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(tlayers.rmsnorm(_t(x), _t(w)).numpy(),
                               _np(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **F32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32)[None] + 7, (2, 5))
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            tlayers.apply_rope(_t(x), _t(pos), theta).numpy(),
            _np(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), **F32)
    b = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(tlayers.layernorm(_t(x), _t(w), _t(b)).numpy(),
                               _np(jlayers.layernorm(jnp.asarray(x), jnp.asarray(w),
                                                     jnp.asarray(b))), **F32)


@pytest.mark.parametrize("causal,skip,q_offset,chunks", [
    (True, False, 0, (8, 8)), (True, True, 0, (8, 4)), (False, False, 0, (16, 8)),
    (True, False, 5, (8, 16))])
def test_chunked_attention_gqa(causal, skip, q_offset, chunks):
    """Online softmax over chunks, GQA (8 query heads over 2 kv heads),
    sequence lengths that pad to the chunks."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 21, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 26 if q_offset else 21, 2, 16)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    kw = dict(causal=causal, q_offset=q_offset, q_chunk=chunks[0], kv_chunk=chunks[1],
              causal_skip=skip)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_decode_attention():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 12, 4, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 12, 4, 24)).astype(np.float32)
    for pos in (0, 6, 11):
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos)
        got = tattn.decode_attention(_t(q), _t(kc), _t(vc), pos)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)


@pytest.mark.parametrize("pattern", ["diag", "banded"])
@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_block_sparse_attention(pattern, backend):
    """``O = P @ V`` as one BSR SpMM, against the reference's (plain) and
    a dense masked oracle."""
    rng = np.random.default_rng(3)
    B, S, H, hd, bs = 2, 32, 3, 8, 8
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    with juse_backend("plain"):
        want = jattn.block_sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            block_size=bs, pattern=pattern)
    with use_backend(backend):
        got = tattn.block_sparse_attention(_t(q), _t(k), _t(v), block_size=bs,
                                           pattern=pattern)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    bc = tattn.block_attention_bcols(S, bs, pattern)
    assert np.array_equal(bc, jattn.block_attention_bcols(S, bs, pattern))
    allowed = np.zeros((S, S), bool)
    for r, row in enumerate(bc):
        for c in row[row >= 0]:
            allowed[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = True
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    s = np.where(allowed, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- init ----


def test_init_is_seeded_and_keeps_the_reference_layout():
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    m = build_model(cfg, device="cpu")
    a = m.init(torch.Generator().manual_seed(3))
    b = m.init(3)
    bf = m.init(3, weight_dtype=torch.bfloat16)
    for (pa, ta), (_, tb), (_, tbf) in zip(sharding.param_paths(a), sharding.param_paths(b),
                                           sharding.param_paths(bf)):
        assert torch.equal(ta, tb)
        want = torch.float32 if pa.endswith("router") else torch.bfloat16
        assert tbf.dtype == want and torch.equal(tbf, ta.to(want))
    assert a["groups"][0]["ffn"]["experts"]["w_gate"].shape == (2, 8, 64, 64)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


