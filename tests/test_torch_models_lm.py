"""The port's LM (``repro_torch.models.model``) and ``launch/serve.py``'s LM
loop against the reference's, the weights carried across with
``params_from_reference``.

f32: logits at ``rtol=1e-4`` with an atol of ``1e-5 * max|logit|`` (sums
over layers reassociated). bf16 activations: ``atol = 8 * eps(bf16) *
max|logit|``, a few bf16 roundings of the largest logit: the port rounds
every op to bf16, the reference's jitted program fuses ops and skips some
of those roundings, and sums run in other orders.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import use_backend as juse_backend
from repro.distributed import sharding as jsharding
from repro.models import build_model as jbuild
from repro.models import moe as jmoe

from repro_torch.configs import get_smoke_config
from repro_torch.core import use_backend
from repro_torch.distributed import sharding
from repro_torch.models import build_model, params_from_reference
from repro_torch.models import moe as tmoe


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _carried(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _lm_pair(arch, dtype, impl=None):
    jc = jget_smoke(arch).replace(dtype=dtype)
    tc = get_smoke_config(arch).replace(dtype=dtype)
    if impl and jc.moe is not None:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, dispatch_impl=impl))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, dispatch_impl=impl))
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tc, device="cpu")
    return jm, params, tm, params_from_reference(tc, _carried(params), device="cpu")


def _logit_tol(dtype, want):
    scale = float(np.abs(want).max())
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-5 * scale)
    return dict(rtol=0, atol=8 * float(jnp.finfo(jnp.bfloat16).eps) * scale)


def _record_routes(monkeypatch, mod, log):
    """Append the top-k experts of every ``_route`` call of ``mod`` to
    ``log``, in call order (the reference's through an ordered host
    callback, which runs inside its jitted programs)."""
    orig = mod._route

    def recording(p, x, mcfg):
        out = orig(p, x, mcfg)
        if mod is jmoe:
            jax.debug.callback(lambda t: log.append(np.asarray(t)), out[1], ordered=True)
        else:
            log.append(out[1].numpy())
        return out

    monkeypatch.setattr(mod, "_route", recording)


@pytest.mark.parametrize("arch,impl,dtype", [
    ("qwen3-moe-235b-a22b", "bsr", "float32"), ("qwen3-moe-235b-a22b", "coo", "float32"),
    ("qwen3-moe-235b-a22b", "bsr", "bfloat16"), ("llama3.2-1b", None, "float32"),
    ("llama3.2-1b", None, "bfloat16"),
    ("deepseek-v2-236b", "sort", "float32"), ("deepseek-v2-236b", "bsr", "float32"),
    ("deepseek-v2-236b", "coo", "float32"), ("deepseek-v2-236b", "bsr", "bfloat16"),
    ("jamba-v0.1-52b", "sort", "float32"), ("jamba-v0.1-52b", "bsr", "float32"),
    ("jamba-v0.1-52b", "bsr", "bfloat16"),
    ("rwkv6-7b", None, "float32"), ("rwkv6-7b", None, "bfloat16")])
def test_lm_prefill_and_teacher_forced_decode(monkeypatch, arch, impl, dtype):
    """Weights carried across with ``params_from_reference``: the last
    position's prefill logits, and every decode step's logits fed the same
    tokens, equal the reference's within the stated tolerance.

    In bf16 a token's router input differs between the packages by a bf16
    rounding, which can move a near-tie between two experts to the other
    side. A batch row's logits are compared at every step up to its first
    step whose routing differs in any layer (its cache carries the flip
    on); at least 3/4 of the row-steps must be compared, the prefill only
    where all of its routing agreed."""
    jm, params, tm, tp = _lm_pair(arch, dtype, impl)
    ref = {jsharding._path_str(path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = dict(sharding.param_paths(tp))
    assert ref.keys() == got.keys()
    for path, t in got.items():
        assert t.dtype == torch.float32 and np.array_equal(ref[path], t.numpy()), path
    B, S = 2, 6
    toks = np.random.default_rng(0).integers(1, jm.cfg.vocab, (B, S)).astype(np.int32)
    bf16 = dtype != "float32"
    jlog, tlog = [], []
    if bf16:
        _record_routes(monkeypatch, jmoe, jlog)
        _record_routes(monkeypatch, tmoe, tlog)
    with juse_backend("plain"):
        want, _, n = jm.prefill(params, jnp.asarray(toks))
        step = jax.jit(jm.decode_step)
        caches = jm.init_caches(B, S + 2)
        want_steps = []
        for t in range(S):
            lg, caches = step(params, jnp.asarray(toks[:, t:t + 1]), caches, t)
            want_steps.append(_np(lg))
        jax.effects_barrier()
    with use_backend("cuda"):
        got, tcaches, tn = tm.prefill(tp, _t(toks))
        caches = tm.init_caches(B, S + 2)
        got_steps = []
        for t in range(S):
            lg, caches = tm.decode_step(tp, _t(toks[:, t:t + 1]), caches, t)
            got_steps.append(lg.float().numpy())
    assert tn == n == S and got.dtype == tm.cfg.activation_dtype
    assert len(jlog) == len(tlog)
    L = len(jlog) // (S + 1)                     # routed layers a call
    same = [np.array_equal(a, b) for a, b in zip(jlog, tlog)]
    if all(same[:L]):
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   **_logit_tol(dtype, _np(want)))
    routed_alike = np.ones(B, bool)
    compared = 0
    for t, (g, w) in enumerate(zip(got_steps, want_steps)):
        for a, b in zip(jlog[L * (t + 1):L * (t + 2)], tlog[L * (t + 1):L * (t + 2)]):
            routed_alike &= (a == b).all(axis=-1)
        np.testing.assert_allclose(g[routed_alike], w[routed_alike], **_logit_tol(dtype, w))
        compared += int(routed_alike.sum())
    assert compared >= 0.75 * B * S, compared
    if not bf16:
        assert compared == B * S


def test_lm_forward_train_and_loss():
    jm, params, tm, tp = _lm_pair("qwen3-moe-235b-a22b", "float32", "bsr")
    rng = np.random.default_rng(4)
    toks = rng.integers(1, jm.cfg.vocab, (2, 8)).astype(np.int32)
    tgts = rng.integers(1, jm.cfg.vocab, (2, 8)).astype(np.int32)
    with juse_backend("plain"):
        logits, aux = jm.forward_train(params, jnp.asarray(toks))
        loss = jm.loss(params, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    with use_backend("cuda"):
        tl, taux = tm.forward_train(tp, _t(toks))
        tloss = tm.loss(tp, {"tokens": _t(toks), "targets": _t(tgts)})
    np.testing.assert_allclose(tl.numpy(), _np(logits), **_logit_tol("float32", _np(logits)))
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)


def test_vision_prefix_stub():
    jm, params, tm, tp = _lm_pair("internvl2-26b", "float32")
    rng = np.random.default_rng(6)
    toks = rng.integers(1, jm.cfg.vocab, (2, 5)).astype(np.int32)
    patches = rng.standard_normal((2, jm.cfg.frontend_tokens, jm.cfg.d_model)).astype(np.float32)
    want, _ = jm.forward_train(params, jnp.asarray(toks), {"patches": jnp.asarray(patches)})
    got, _ = tm.forward_train(tp, _t(toks), {"patches": _t(patches)})
    assert got.shape == (2, 5, jm.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **_logit_tol("float32", _np(want)))


def test_params_from_reference_refuses_another_model():
    _, params, _, _ = _lm_pair("llama3.2-1b", "float32")
    with pytest.raises(ValueError, match="does not fit"):
        params_from_reference(get_smoke_config("qwen3-moe-235b-a22b"), _carried(params),
                              device="cpu")


# ------------------------------------------------------------------ serve_lm ----


def test_serve_lm_greedy_tokens_equal_the_reference(monkeypatch, capsys):
    """``serve_lm --smoke --device cpu`` in f32 on the reference's weights:
    the greedy tokens equal those of the reference's own decode loop, and
    its printed continuation equals the reference's ``serve_lm``'s."""
    _serve_lm_against_reference(monkeypatch, capsys, "qwen3-moe-235b-a22b")


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "whisper-base"])
def test_serve_lm_greedy_tokens_equal_the_reference_new_families(monkeypatch, capsys, arch):
    """The same for MLA with shared experts on the default ('sort') lane,
    and for the encoder-decoder, whose loop draws the frames and leaves
    the cross caches at zero, as the reference's does."""
    _serve_lm_against_reference(monkeypatch, capsys, arch)


def _serve_lm_against_reference(monkeypatch, capsys, arch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    f32 = lambda get: (lambda arch: get(arch).replace(dtype="float32"))  # noqa: E731
    monkeypatch.setattr(jserve, "get_smoke_config", f32(jget_smoke))
    monkeypatch.setattr(tserve, "get_smoke_config", f32(get_smoke_config))
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--gen", "5", "--seed", "2"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with juse_backend("plain"):
        jserve.main()
    ref_line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("sample continuation")]
    args = types.SimpleNamespace(arch=arch, smoke=True, batch=2, prompt_len=6,
                                 gen=5, seed=2, layers=0, dispatch_impl=None,
                                 device="cpu", graph=False)
    cfg = tserve.lm_config(args)
    jm = jbuild(jget_smoke(args.arch).replace(dtype="float32"))
    params = jm.init(jax.random.PRNGKey(2))
    out = tserve.serve_lm(args, params=params_from_reference(cfg, _carried(params), "cpu"))
    got_line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("sample continuation")]
    assert got_line == ref_line
    # the reference's loop, step by step, on the same prompt
    caches = jm.init_caches(2, 11)
    toks = jnp.asarray(out["prompt"].numpy())
    with juse_backend("plain"):
        for t in range(6):
            logits, caches = jm.decode_step(params, toks[:, t:t + 1], caches, t)
        want = []
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        for g in range(5):
            assert np.array_equal(out["fed"][:, g].numpy(), np.asarray(tok[:, 0]))
            logits, caches = jm.decode_step(params, tok, caches, 6 + g)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            want.append(np.asarray(tok[:, 0]))
    assert np.array_equal(out["generated"].numpy(), np.stack(want, 1))
    assert out["stats"].summary()["requests"] == 5


def test_serve_main_selects_the_lm_loop(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--batch", "2", "--prompt-len", "4",
          "--gen", "3", "--dispatch-impl", "bsr", "--layers", "1", "--device", "cpu",
          "--no-graph"])
    out = capsys.readouterr().out
    assert "arch=qwen3-moe-smoke layers=1 B=2 prompt=4 gen=3 device=cpu" in out
    assert "tok/s" in out and "sample continuation" in out
