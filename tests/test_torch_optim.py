"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
(``repro.optim.adamw``) on the same numpy trees.

Each framework rounds its own f32 ``pow`` and ``sqrt`` and sums the global
norm in its own order, so the comparison holds at rtol 1e-6, with an atol
of 1e-6 max|leaf| for an element that a step brings near zero (it carries
the rounding of its larger operands). The port updates in place; each test
hands it fresh copies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map

RTOL = 1e-6


def _tree(seed=0):
    """A tree with f32 and bf16 leaves, a list and nested dicts (numpy
    f32 values; the bf16 leaves on the bf16 grid)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(8, 16), "b": f(16), "layers": [{"k": f(4, 4), "q": f(3)}, {"k": f(4, 4)}],
            "emb": f(6, 5)}


BF16 = ("w", "emb")


def _ref_params(tree, bf16):
    out = {k: jnp.asarray(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: jnp.asarray(v) for k, v in d.items()} for d in tree["layers"]]
    if bf16:
        for k in BF16:
            out[k] = out[k].astype(jnp.bfloat16)
    return out


def _port_params(tree, bf16):
    out = {k: torch.from_numpy(v.copy()) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: torch.from_numpy(v.copy()) for k, v in d.items()}
                     for d in tree["layers"]]
    if bf16:
        for k in BF16:
            out[k] = out[k].to(torch.bfloat16)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_tree(got, want, rtol=RTOL):
    g, w = tree_leaves(got), _jleaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, rtol=rtol, atol=rtol * float(np.abs(b).max()))


def _jleaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("keep_master,bf16", [(False, False), (True, True), (False, True)])
def test_update_matches_reference(keep_master, bf16):
    """Three steps over a tree with bf16 leaves (and an f32 master kept
    beside them): params, m, v, master, grad_norm and lr as the
    reference's. The gradients are large enough to clip on step 1."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=5.0)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=5.0)
    tree = _tree(0)
    jp, tp = _ref_params(tree, bf16), _port_params(tree, bf16)
    js, ts = jadamw.init(jp, keep_master=keep_master), adamw.init(tp, keep_master=keep_master)
    for step in range(3):
        g = _tree(10 + step)
        scale = 3.0 if step == 0 else 0.1
        jg = jax.tree_util.tree_map(lambda v: v * scale, _ref_params(g, False))
        tg = tree_map(lambda t: t * scale, _port_params(g, False))
        jp, js, jm = jadamw.update(jcfg, jg, js, jp)
        tp, ts, tm = adamw.update(cfg, tg, ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=RTOL)
        assert int(ts.step) == int(js.step) == step + 1
        _assert_tree(tp, jp)
        _assert_tree(ts.m, js.m)
        _assert_tree(ts.v, js.v)
        if keep_master:
            _assert_tree(ts.master, js.master)
        else:
            assert ts.master is None and js.master is None
    for k in BF16:
        assert tp[k].dtype is (torch.bfloat16 if bf16 else torch.float32)


def test_update_is_in_place():
    tp = _port_params(_tree(0), True)
    ts = adamw.init(tp, keep_master=True)
    ids = [t.data_ptr() for t in tree_leaves((tp, ts.m, ts.v, ts.master))]
    p2, s2, _ = adamw.update(adamw.AdamWConfig(), _port_params(_tree(1), False), ts, tp)
    assert [t.data_ptr() for t in tree_leaves((p2, s2.m, s2.v, s2.master))] == ids


def test_update_in_chunks_matches_whole(monkeypatch):
    """A leaf updated in chunks (``CHUNK`` cut to 7 elements) gives the
    same bits as in one piece: the update is elementwise."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    out = []
    for chunk in (adamw.CHUNK, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        tp = _port_params(_tree(0), True)
        ts = adamw.init(tp, keep_master=True)
        tp, ts, _ = adamw.update(cfg, _port_params(_tree(1), False), ts, tp)
        out.append(tree_leaves((tp, ts.m, ts.v, ts.master)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 50, 99])
def test_schedule_matches_reference(step):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100)
    np.testing.assert_allclose(float(adamw.schedule(cfg, torch.tensor(step))),
                               float(jadamw.schedule(jcfg, jnp.asarray(step))), rtol=RTOL)


def test_global_norm_matches_reference():
    tree = _tree(3)
    np.testing.assert_allclose(float(adamw.global_norm(_port_params(tree, True))),
                               float(jadamw.global_norm(_ref_params(tree, True))), rtol=RTOL)


def test_optimizer_sanity():
    """Twin of the reference's ``test_optimizer_sanity``."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100, weight_decay=0.0)
    params = {"w": torch.ones((4,))}
    state = adamw.init(params)
    g = {"w": torch.full((4,), 0.5)}
    p1, state, m = adamw.update(cfg, g, state, params)
    assert float(m["lr"]) > 0
    assert (p1["w"] < 1.0).all()     # moved against gradient
    lrs = [float(adamw.schedule(cfg, torch.tensor(s))) for s in (0, 1, 50, 99)]
    assert lrs[0] < lrs[1] and lrs[1] >= lrs[2] >= lrs[3]


def test_zero_master_optimizer_matches_f32():
    """Twin of the reference's ``test_zero_master_optimizer_matches_f32``:
    bf16 params with an f32 master track the pure-f32 optimizer."""
    cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.0, clip_norm=1e9)
    p16 = {"w": torch.linspace(-1, 1, 64, dtype=torch.float32).to(torch.bfloat16)}
    p32 = {"w": p16["w"].to(torch.float32)}
    s32 = adamw.init(p32)
    s16 = adamw.init(p16, keep_master=True)
    g = {"w": torch.sin(torch.arange(64, dtype=torch.float32))}
    for _ in range(5):
        p32, s32, _ = adamw.update(cfg, g, s32, p32)
        p16, s16, _ = adamw.update(cfg, g, s16, p16)
    np.testing.assert_allclose(s16.master["w"].numpy(), p32["w"].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p16["w"].float().numpy(), p32["w"].numpy(), rtol=1e-2, atol=1e-2)
