"""The port's MLA (``models/mla.py``), Mamba (``models/ssm.py``), RWKV-6
(``models/rwkv.py``) and encoder-decoder (``model.EncDecLM``) against the
reference's on the same numpy inputs and weights (smoke configs), plus the
port's own decode-vs-train consistency (the reference's
``tests/test_models.py:56-91``) and the decode step's state carry.

f32: ``rtol=1e-4`` with an atol of ``1e-5 * max|want|``; bf16 activations:
``atol = 8 * eps(bf16) * max|want|`` (the LM tests' rules).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_model as jbuild
from repro.models import mla as jmla
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import lm_config
from repro_torch.models import build_model, params_from_reference
from repro_torch.models import mla as tmla
from repro_torch.models.layers import Init
from repro_torch.models.model import layer, tree_leaves
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm

DTYPES = ["float32", "bfloat16"]


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree(p):
    return jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), p)


def _close(got, want, dtype, what=""):
    want = _np(want)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    scale = float(np.abs(want).max()) or 1.0
    if dtype == "float32":
        tol = dict(rtol=1e-4, atol=1e-5 * scale)
    else:
        tol = dict(rtol=0, atol=8 * float(jnp.finfo(jnp.bfloat16).eps) * scale)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _cfgs(arch, dtype):
    return jget_smoke(arch).replace(dtype=dtype), get_smoke_config(arch).replace(dtype=dtype)


def _x(cfg, B, S, seed=0):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(cfg.activation_dtype), _t(x).to(
        torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def _pos(B, S, start=0):
    p = np.broadcast_to(np.arange(start, start + S, dtype=np.int32)[None], (B, S))
    return jnp.asarray(p), _t(p)


# ----------------------------------------------------------------------- MLA ----


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_train_prefill_and_decode_step_by_step(dtype):
    jc, tc = _cfgs("deepseek-v2-236b", dtype)
    p = jmla.init_mla(jax.random.PRNGKey(0), jc)
    tp = _tree(p)
    B, S = 2, 7
    xj, xt = _x(jc, B, S)
    pj, pt = _pos(B, S)
    _close(tmla.mla_train(tp, xt, tc, pt), jmla.mla_train(p, xj, jc, pj), dtype, "train")
    (oj, cj), (ot, ct) = jmla.mla_prefill(p, xj, jc, pj), tmla.mla_prefill(tp, xt, tc, pt)
    _close(ot, oj, dtype, "prefill")
    _close(ct.c_kv, cj.c_kv, dtype, "prefill c_kv")
    _close(ct.k_pe, cj.k_pe, dtype, "prefill k_pe")
    act = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jcache = jmla.init_mla_cache(jc, B, S + 1, jc.activation_dtype)
    tcache = tmla.init_mla_cache(tc, B, S + 1, act, "cpu")
    for t in range(S):
        oj, jcache = jmla.mla_decode(p, xj[:, t:t + 1], jc, jcache, t)
        ot, tcache2 = tmla.mla_decode(tp, xt[:, t:t + 1], tc, tcache, t)
        assert tcache2.c_kv is tcache.c_kv  # written in place at t
        _close(ot, oj, dtype, f"decode step {t}")
        _close(tcache.c_kv, jcache.c_kv, dtype, f"c_kv after step {t}")
        _close(tcache.k_pe, jcache.k_pe, dtype, f"k_pe after step {t}")
    assert not tcache.c_kv[:, S].any()


def test_mla_absorbed_decode_matches_direct_form():
    """The absorbed decode fed the sequence token by token against the
    direct form, at the reference's own bound (0.05 max|want|, f32)."""
    _, tc = _cfgs("deepseek-v2-236b", "float32")
    tp = tmla.init_mla(Init(torch.Generator().manual_seed(0), "cpu"), tc)
    B, S = 2, 8
    xt = _t(np.random.default_rng(3).standard_normal((B, S, tc.d_model)).astype(np.float32))
    want = tmla.mla_train(tp, xt, tc, _pos(B, S)[1])
    cache = tmla.init_mla_cache(tc, B, S, torch.float32, "cpu")
    got = torch.cat([tmla.mla_decode(tp, xt[:, t:t + 1], tc, cache, t)[0] for t in range(S)], 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=0.05 * float(want.abs().max()))


# --------------------------------------------------------------------- Mamba ----


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_forward_and_decode_carry_the_conv_context(dtype):
    """Whole-sequence forward; the same sequence in two chunks (the second
    shorter than the conv window, so the new window keeps some of the
    first chunk); and decode token by token, each step's state fed to the
    next: outputs and states against the reference's."""
    jc, tc = _cfgs("jamba-v0.1-52b", dtype)
    p = jssm.init_mamba(jax.random.PRNGKey(1), jc)
    tp = _tree(p)
    B, S, S1 = 2, 8, 6
    xj, xt = _x(jc, B, S, seed=1)
    (oj, sj), (ot, st) = jssm.mamba_forward(p, xj, jc), tssm.mamba_forward(tp, xt, tc)
    _close(ot, oj, dtype, "forward")
    _close(st.conv, sj.conv, dtype, "conv window")
    _close(st.ssm, sj.ssm, dtype, "ssm state")
    oj1, sj1 = jssm.mamba_forward(p, xj[:, :S1], jc)
    oj2, sj2 = jssm.mamba_forward(p, xj[:, S1:], jc, sj1)
    ot1, st1 = tssm.mamba_forward(tp, xt[:, :S1], tc)
    ot2, st2 = tssm.mamba_forward(tp, xt[:, S1:], tc, st1)
    _close(ot2, oj2, dtype, "second chunk")
    _close(st2.conv, sj2.conv, dtype, "conv window after two chunks")
    _close(st2.ssm, sj2.ssm, dtype, "ssm state after two chunks")
    act = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    sj = jssm.init_mamba_state(jc, B, jc.activation_dtype)
    st = tssm.init_mamba_state(tc, B, act, "cpu")
    for t in range(S):
        oj, sj = jssm.mamba_decode(p, xj[:, t:t + 1], jc, sj)
        ot, st = tssm.mamba_decode(tp, xt[:, t:t + 1], tc, st)
        _close(ot, oj, dtype, f"decode step {t}")
        _close(st.conv, sj.conv, dtype, f"conv window after step {t}")
        _close(st.ssm, sj.ssm, dtype, f"ssm state after step {t}")


def test_mamba_init_keeps_the_reference_leaves():
    _, tc = _cfgs("jamba-v0.1-52b", "float32")
    want = jax.eval_shape(lambda k: jssm.init_mamba(k, jget_smoke("jamba-v0.1-52b")),
                          jax.random.PRNGKey(0))
    got = tssm.init_mamba(Init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16), tc)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in ("dt_bias", "A_log", "D"):  # used in f32, kept in f32
        assert got[k].dtype == torch.float32
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6
    assert torch.equal(got["A_log"][0], torch.log(torch.arange(1.0, tc.mamba.d_state + 1)))


# ---------------------------------------------------------------------- RWKV ----


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_and_channel_mix(dtype, with_state):
    jc, tc = _cfgs("rwkv6-7b", dtype)
    p = jrwkv.init_rwkv(jax.random.PRNGKey(2), jc)
    tp = _tree(p)
    B, S = 2, 5
    xj, xt = _x(jc, B, S, seed=2)
    js = ts = None
    if with_state:
        rng = np.random.default_rng(4)
        H, hd = jrwkv._dims(jc)
        parts = [rng.standard_normal((B, jc.d_model)).astype(np.float32),
                 rng.standard_normal((B, jc.d_model)).astype(np.float32),
                 rng.standard_normal((B, H, hd, hd)).astype(np.float32)]
        js = jrwkv.RWKVState(jnp.asarray(parts[0]).astype(jc.activation_dtype),
                             jnp.asarray(parts[1]).astype(jc.activation_dtype),
                             jnp.asarray(parts[2]))
        ts = trwkv.RWKVState(_t(parts[0]).to(xt.dtype), _t(parts[1]).to(xt.dtype), _t(parts[2]))
    yj, shj, wj = jrwkv.rwkv_time_mix(p, xj, jc, js)
    yt, sht, wt = trwkv.rwkv_time_mix(tp, xt, tc, ts)
    _close(yt, yj, dtype, "time mix")
    assert torch.equal(sht, xt[:, -1])
    _close(wt, wj, dtype, "wkv state")
    cj, cshj = jrwkv.rwkv_channel_mix(p, xj, jc, js)
    ct, csht = trwkv.rwkv_channel_mix(tp, xt, tc, ts)
    _close(ct, cj, dtype, "channel mix")
    assert torch.equal(csht, xt[:, -1])


# --------------------------------------------------------------- enc-dec (whisper) ----


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_encode_train_prefill_and_decode(dtype):
    """``encode``, ``forward_train`` and ``prefill`` on seeded frames; then
    ``decode_step`` teacher-forced against caches holding the prefill's
    cross K/V: logits and caches against the reference's, step by step."""
    jc, tc = _cfgs("whisper-base", dtype)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(3))
    tm = build_model(tc, device="cpu")
    tp = params_from_reference(tc, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(6)
    B, S, F = 2, 6, jc.frontend_tokens
    toks = rng.integers(1, jc.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, F, jc.d_model)).astype(np.float32)
    je, te = {"frames": jnp.asarray(frames)}, {"frames": _t(frames)}
    _close(tm.encode(tp, te["frames"]), jm.encode(params, je["frames"]), dtype, "encode")
    lj, _ = jm.forward_train(params, jnp.asarray(toks), je)
    lt, aux = tm.forward_train(tp, _t(toks), te)
    _close(lt, lj, dtype, "forward_train")
    assert float(aux) == 0.0
    tgts = rng.integers(1, jc.vocab, (B, S)).astype(np.int32)
    np.testing.assert_allclose(
        float(tm.loss(tp, {"tokens": _t(toks), "targets": _t(tgts), **te})),
        float(jm.loss(params, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts), **je})),
        rtol=1e-5 if dtype == "float32" else 2e-2)
    pj, cj, nj = jm.prefill(params, jnp.asarray(toks), je)
    pt, ct, nt = tm.prefill(tp, _t(toks), te)
    assert nj == nt == S
    _close(pt, pj, dtype, "prefill")
    for a, b in ((ct.self_kv.k, cj.self_kv.k), (ct.cross_kv.k, cj.cross_kv.k),
                 (ct.cross_kv.v, cj.cross_kv.v)):
        _close(a, b, dtype, "prefill caches")
    jcache = jm.init_caches(B, S + 1, enc_len=F)._replace(cross_kv=cj.cross_kv)
    tcache = tm.init_caches(B, S + 1, enc_len=F)
    tcache.cross_kv.k.copy_(ct.cross_kv.k)
    tcache.cross_kv.v.copy_(ct.cross_kv.v)
    for t in range(S):
        gj, jcache = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), jcache, t)
        gt, tcache = tm.decode_step(tp, _t(toks[:, t:t + 1]), tcache, t)
        _close(gt, gj, dtype, f"decode step {t}")
        if dtype == "float32":  # decode with the real cross K/V is the train pass
            _close(gt, _np(lj[:, t]), "bfloat16", f"decode step {t} vs forward_train")
    _close(tcache.self_kv.k, jcache.self_kv.k, dtype, "self caches after decode")


# ------------------------------------------------------------- decode vs train ----


@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-v0.1-52b", "rwkv6-7b",
                                  "deepseek-v2-236b", "qwen3-moe-235b-a22b"])
def test_decode_matches_train(arch):
    """The reference's own check (``tests/test_models.py``) on the port: the
    decode loop's last logits against ``forward_train``'s at 0.05 max|want|
    (MoE at capacity factor 8, MLA in f32)."""
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    if cfg.mla is not None:
        cfg = cfg.replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    B, S = 2, 8
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (B, S))
                            .astype(np.int32))
    lt, _ = model.forward_train(params, toks)
    caches = model.init_caches(B, S + 2)
    for t in range(S):
        logits, caches = model.decode_step(params, toks[:, t:t + 1], caches, t)
    ref = lt[:, -1].float().numpy()
    np.testing.assert_allclose(logits.float().numpy(), ref, rtol=0,
                               atol=0.05 * np.abs(ref).max(), err_msg=arch)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b"])
def test_decode_step_carries_the_recurrent_state(arch):
    """``decode_step`` writes each Mamba/RWKV layer's returned state into its
    cache slice: after step t the caches hold step t's state (equal to the
    block's own return), and step t+1 from them differs from a step from
    zeroed caches."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(1)
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    caches = model.init_caches(2, 4)
    _, caches = model.decode_step(params, tok, caches, 0)
    g, gp, gc = model.groups[0], params["groups"][0], caches[0]
    fresh = model.init_caches(2, 4)[0]
    x = model._embed(params, tok)
    _, want = g.decode(layer(gp, 0), x, layer(fresh, 0), 0, {})
    for a, b in zip(tree_leaves(layer(gc, 0)), tree_leaves(want)):
        assert torch.equal(a, b)
    assert any(bool(t.abs().sum() > 0) for t in tree_leaves(gc))
    after, _ = model.decode_step(params, tok, caches, 1)
    from_zero, _ = model.decode_step(params, tok, model.init_caches(2, 4), 1)
    assert not torch.equal(after, from_zero)


def test_jamba_cut_must_be_whole_periods():
    args = types.SimpleNamespace(arch="jamba-v0.1-52b", smoke=False, layers=12,
                                 dispatch_impl="bsr")
    with pytest.raises(ValueError, match="whole periods of 8"):
        lm_config(args)
    assert lm_config(types.SimpleNamespace(**{**vars(args), "layers": 8})).n_layers == 8
    with pytest.raises(ValueError, match="not a multiple of attn_period"):
        build_model(get_smoke_config("jamba-v0.1-52b").replace(n_layers=6), device="cpu")
