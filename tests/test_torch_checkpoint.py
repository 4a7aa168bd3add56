"""The port's checkpoint manager and data pipeline against the reference's.

Checkpoints: the flattened keys of a (params, ``AdamWState``) tree are the
reference's ``_flatten`` keys; a checkpoint written by the reference
restores into the port with equal arrays (its bf16 leaves included, read
back from their raw 2-byte records), and one written by the port restores
into the reference (f32 and int leaves: a port bf16 leaf is its uint16
bits, which the reference reads as such). Twins of
``tests/test_checkpoint.py``'s roundtrip, retention, no-tmp-dirs, async and
shape-mismatch tests, and of its ``test_elastic_restore_across_mesh_shapes``
(saved from a (4,) mesh of four ``gloo`` ranks, restored onto (2, 2) with
``("data", "model")`` placements: equal values; a batch split over the
mesh by ``SyntheticTokens(mesh=)`` too). Data: ``SyntheticTokens.batch_at``
gives the reference's arrays bit for bit for every frontend, and so does a
resumed stream.
"""
import dataclasses
import pathlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.configs import get_smoke_config as jget_smoke
from repro.data.pipeline import DataState as JDataState, SyntheticTokens as JTokens
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager, config_hash
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataState, SyntheticTokens
from repro_torch.models.from_reference import params_from_reference
from repro_torch.optim import adamw
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import map_with_path, rebuild, tree_map

ARCH = "qwen3-moe-235b-a22b"


def _trees(keep_master=False):
    """The reference's (params, AdamWState) of the MoE smoke config after
    init, and the port's copy of the same values."""
    jcfg = jget_smoke(ARCH)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    if keep_master:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    jtree = {"params": jp, "opt": jadamw.init(jp, keep_master=keep_master)}
    tp = params_from_reference(get_smoke_config(ARCH),
                               jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ttree = {"params": tp, "opt": adamw.init(tp, keep_master=keep_master)}
    return jtree, ttree


def _np(t):
    return t.float().numpy() if t.dtype is torch.bfloat16 else t.numpy()


def test_keys_are_the_references():
    jtree, ttree = _trees(keep_master=True)
    assert set(manager._flatten(ttree)) == set(jmanager._flatten(jtree))
    assert "opt/step" in manager._flatten(ttree)


def _mixed_tree(leaf):
    """A tree with every node kind the port walks: dicts in unsorted key
    order, a list, a tuple, a named tuple with a ``None`` field."""
    class State(NamedTuple):
        step: object
        m: object
        master: object = None

    return {"b": [leaf(2), (leaf(3), leaf(4))], "a": State(leaf(0), {"z": leaf(1), "y": leaf(5)}),
            "c": None}


@pytest.mark.parametrize("walk", ["leaves", "map", "keys", "rebuild"])
def test_tree_walk_is_jaxs(walk):
    """``repro_torch.tree`` visits leaves in ``jax.tree_util``'s order, keeps
    ``None`` and the tree's structure, and names each leaf by the
    reference's flattened key."""
    jt = _mixed_tree(lambda i: np.float32(i))
    tt = _mixed_tree(lambda i: torch.tensor(float(i)))
    want = [float(x) for x in jax.tree_util.tree_leaves(jt)]
    if walk == "leaves":
        assert [float(t) for t in tree_leaves(tt)] == want
    elif walk == "map":
        got = tree_map(lambda t: t * 2, tt)
        assert list(got) == ["b", "a", "c"] and got["c"] is None and got["a"].master is None
        assert [float(t) for t in tree_leaves(got)] == [2 * w for w in want]
    elif walk == "keys":
        seen = []
        map_with_path(lambda k, t: seen.append(k), tt)
        assert seen == list(jmanager._flatten(jt))
    else:
        got = rebuild(tt, range(len(want)))
        assert tree_leaves(got) == list(range(len(want)))
        assert type(got["a"]) is type(tt["a"]) and isinstance(got["b"][1], tuple)


def test_config_hash_is_the_references():
    assert config_hash(get_smoke_config(ARCH)) == jmanager.config_hash(jget_smoke(ARCH))


@pytest.mark.parametrize("keep_master", [False, True])
def test_reference_checkpoint_restores_into_the_port(tmp_path, keep_master):
    jtree, ttree = _trees(keep_master)
    jmanager.CheckpointManager(tmp_path).save(3, jtree, meta={"data_state": {"step": 3}})
    cm = CheckpointManager(tmp_path)
    assert cm.latest_step() == 3 and cm.manifest()["data_state"] == {"step": 3}
    got = cm.restore(ttree)
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for j, t, want in zip(jl, tl, tree_leaves(ttree)):
        assert t.dtype == want.dtype and t.device.type == "cpu"
        np.testing.assert_array_equal(_np(t), np.asarray(jnp.asarray(j, jnp.float32)
                                                         if j.dtype == jnp.bfloat16 else j))


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jtree, ttree = _trees()
    for t in tree_leaves(ttree["params"]):  # move off init so a mix-up shows
        t.add_(0.5)
    CheckpointManager(tmp_path).save(4, ttree, meta={"data_state": {"step": 4}})
    got = jmanager.CheckpointManager(tmp_path).restore(jtree)
    for j, t in zip(jax.tree_util.tree_leaves(got), tree_leaves(ttree)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_bf16_roundtrip_records_its_dtype(tmp_path):
    _, ttree = _trees(keep_master=True)
    cm = CheckpointManager(tmp_path)
    cm.save(1, ttree)
    assert "params/embed" in cm.manifest()["bfloat16"]
    got = cm.restore(ttree)
    for a, b in zip(tree_leaves(got), tree_leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": [torch.ones((3,)), torch.zeros((2, 2))]}}


def test_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path, keep_last=2)
    t = _tree()
    cm.save(7, t, meta={"data_state": {"step": 7}})
    got = cm.restore(tree_map(torch.zeros_like, t))
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert torch.equal(a, b)
    assert cm.manifest()["step"] == 7
    assert cm.manifest()["data_state"]["step"] == 7


def test_retention_and_latest(tmp_path):
    cm = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        cm.save(s, {"x": torch.full((2,), s)})
    assert cm.steps() == [3, 4]
    assert cm.latest_step() == 4


def test_no_tmp_dirs_left(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree())
    assert list(pathlib.Path(tmp_path).glob(".tmp*")) == []


def test_async_save_snapshots_before_returning(tmp_path):
    """The write runs on a thread, but the snapshot is taken before
    ``save`` returns: an in-place update after it does not reach the file."""
    cm = CheckpointManager(tmp_path)
    t = _tree()
    want = t["a"].clone()
    cm.save(5, t, async_=True)
    t["a"].add_(1.0)
    cm.wait()
    assert cm.latest_step() == 5
    assert torch.equal(cm.restore(_tree())["a"], want)


ELASTIC = r'''
def body(rank, world, tmp):
    import numpy as np
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import device_mesh
    from torch.distributed.device_mesh import init_device_mesh
    mesh_a = device_mesh(("data",), (4,), device="cpu")
    full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    x = distribute_tensor(full, mesh_a, [Shard(0)], src_data_rank=None)
    cm = CheckpointManager(os.path.join(tmp, "ckpt"))
    cm.save(3, {"w": x})                      # every rank gathers, rank 0 writes
    dist.barrier()
    # elastic: new mesh shape (2, 2), another partitioning
    mesh_b = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    got = cm.restore_sharded({"w": torch.empty(8, 8, device="meta")},
                             {"w": (Shard(0), Shard(1))}, mesh=mesh_b)["w"]
    r, c = mesh_b.get_local_rank("data"), mesh_b.get_local_rank("model")
    batch = SyntheticTokens(64, 8, 4, seed=1, mesh=mesh_b, device="cpu")
    b = batch._put(batch.batch_at(0))["tokens"]
    whole = torch.from_numpy(batch.batch_at(0)["tokens"])
    return {"equal": bool(torch.equal(got.full_tensor(), full)),
            "placements": [type(p).__name__ for p in got.placements],
            "local": bool(torch.equal(got.to_local(), full[4 * r:4 * r + 4, 4 * c:4 * c + 4])),
            "batch": [type(p).__name__ for p in b.placements],
            "batch_local": bool(torch.equal(b.to_local(), whole[2 * r:2 * r + 2]))}
'''


def test_elastic_restore_across_mesh_shapes(tmp_path):
    """Save sharded over four ranks, restore onto a 2x2 mesh: the file
    holds the full logical array, so resharding costs nothing."""
    from test_torch_sharding import run_ranks

    out = run_ranks(ELASTIC, tmp_path)
    assert out == {"equal": True, "placements": ["Shard", "Shard"], "local": True,
                   "batch": ["Shard", "Replicate"], "batch_local": True}


def test_shape_mismatch_rejected(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"x": torch.ones((4,))})
    with pytest.raises(ValueError):
        cm.restore({"x": torch.ones((5,))})


@pytest.mark.parametrize("frontend", ["none", "vision", "audio"])
def test_batch_at_is_the_references(frontend):
    kw = dict(vocab=256, seq_len=24, global_batch=3, seed=5, frontend=frontend,
              frontend_tokens=4 if frontend != "none" else 0, d_model=16)
    ours, ref = SyntheticTokens(device="cpu", **kw), JTokens(**kw)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_resumed_stream_is_the_references():
    kw = dict(vocab=256, seq_len=16, global_batch=2, seed=3)
    ours = SyntheticTokens(device="cpu", **kw).resume(DataState(7))
    ref = JTokens(**kw).resume(JDataState(7))
    for _ in range(3):
        a, b = next(ours), next(ref)
        for k in a:
            assert isinstance(a[k], torch.Tensor)
            assert np.array_equal(a[k].numpy(), np.asarray(b[k]))
    assert ours.state == DataState(10) and ref.state.to_dict() == {"step": 10}
    assert DataState.from_dict(ours.state.to_dict()) == ours.state


def test_dataclass_roundtrip():
    assert dataclasses.asdict(DataState(4)) == {"step": 4}
